"""FLYCOO sparse tensor format (paper Sec. 3) — host-side half.

The port's copy of ``repro.core.flycoo``: plans and dedup tables are
numpy and bitwise-equal to the reference's (tested).

A tensor element is the tuple ``<alpha_i, beta_i, val_i>`` (paper Sec. 3.5):
``beta_i`` = per-mode indices, ``alpha_i`` = per-mode remap ids (the
element's physical slot in every mode's kernel layout).

In-block factor-row dedup
-------------------------
:meth:`FlycooTensor.dedup_tables` sorts each block's factor-row list and
emits

  uidx  (N-1, S_d)       per block, the ``U <= P`` *unique* rows, compacted
                         to the block's first slots (rest zero-padded);
  upos  (S_d, N-1)       per slot, the local stage position of its row
                         among the block's uniques (0 for pad slots);
  nuniq (N-1, nblocks)   per block, the unique-row count ``U``,

so the kernel stages ``U`` rows per block and factor instead of ``P`` and
reads each slot's operand at ``upos``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.obs.trace import span as _obs_span

from .partition import DEFAULT_SCHEDULE, ModePlan, plan_mode

_ROW_SENTINEL = np.iinfo(np.int32).max  # pad-slot marker; sorts last


def _dedup_tables_batched(rows: np.ndarray, nblocks: int, block_p: int):
    """Build (uidx, upos, nuniq) for ``F`` factors' per-slot row lists.

    ``rows`` is ``(F, S)`` integer with ``_ROW_SENTINEL`` marking pad
    slots; ``S == nblocks * block_p``. Vectorized over factors and blocks:
    sort each block's rows, mark firsts, compact the uniques to the
    block's front, and record every slot's position among them.
    """
    f = rows.shape[0]
    s = nblocks * block_p
    if rows.shape != (f, s):
        raise ValueError(f"rows {rows.shape} != ({f}, {nblocks}*{block_p})")
    rb = np.ascontiguousarray(rows, dtype=np.int32).reshape(
        f, nblocks, block_p)
    # equal rows share one upos/uidx entry, so sort stability is irrelevant
    order = np.argsort(rb, axis=2)
    srt = np.take_along_axis(rb, order, axis=2)
    isnew = np.ones(srt.shape, dtype=bool)
    isnew[:, :, 1:] = srt[:, :, 1:] != srt[:, :, :-1]
    isnew &= srt != _ROW_SENTINEL          # sentinels are not unique rows
    upos_sorted = np.maximum(
        np.cumsum(isnew, axis=2, dtype=np.int32) - 1, 0)
    upos = np.zeros(srt.shape, dtype=np.int32)
    np.put_along_axis(upos, order, upos_sorted, axis=2)
    upos[rb == _ROW_SENTINEL] = 0          # pad slots -> stage row 0
    nuniq = isnew.sum(axis=2).astype(np.int32)
    uidx = np.zeros(srt.shape, dtype=np.int32)
    fix, bix, six = np.nonzero(isnew)
    uidx[fix, bix, upos_sorted[fix, bix, six]] = srt[fix, bix, six]
    return uidx.reshape(f, s), upos.reshape(f, s), nuniq


def dedup_tables_from_rows(rows: np.ndarray, nblocks: int, block_p: int):
    """Single-factor form of :func:`_dedup_tables_batched`: ``rows`` is
    ``(S,)`` with ``_ROW_SENTINEL`` marking pad slots; returns ``(uidx
    (S,), upos (S,), nuniq (nblocks,))`` int32."""
    uidx, upos, nuniq = _dedup_tables_batched(
        np.asarray(rows)[None, :], nblocks, block_p)
    return uidx[0], upos[0], nuniq[0]


@dataclasses.dataclass
class FlycooTensor:
    """A sparse tensor in FLYCOO format (host-side container).

    ``indices``/``values`` are kept in canonical (input) element order for
    reference computations; ``plans[d]`` carries each mode's kernel layout.
    """

    dims: tuple[int, ...]
    indices: np.ndarray           # (nnz, N) int32, canonical order
    values: np.ndarray            # (nnz,) float32, canonical order
    plans: list[ModePlan]
    _dedup_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def nmodes(self) -> int:
        return len(self.dims)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def layout_arrays(self, d: int) -> dict[str, np.ndarray]:
        """Materialize the mode-d kernel layout arrays (val/idx/lrow/dst)."""
        plan = self.plans[d]
        nxt = self.plans[(d + 1) % self.nmodes]
        S = plan.padded_nnz
        val = np.zeros(S, dtype=np.float32)
        idx = np.zeros((S, self.nmodes), dtype=np.int32)
        lrow = np.full(S, -1, dtype=np.int32)
        dst = np.full(S, -1, dtype=np.int32)

        slots = plan.slot_of_elem
        val[slots] = self.values
        idx[slots] = self.indices
        rel = plan.row_relabel[self.indices[:, d]].astype(np.int64)
        lrow[slots] = (rel % plan.rows_pp).astype(np.int32)
        dst[slots] = nxt.slot_of_elem.astype(np.int32)
        return {"val": val, "idx": idx, "lrow": lrow, "dst": dst}

    def _slot_rows(self, d: int) -> np.ndarray:
        """(N-1, S_d) int32 factor row per mode-``d`` slot for every input
        mode ``w != d`` in ascending mode order (sentinel marks pads)."""
        plan = self.plans[d]
        in_modes = [w for w in range(self.nmodes) if w != d]
        rows = np.full((len(in_modes), plan.padded_nnz), _ROW_SENTINEL,
                       dtype=np.int32)
        rows[:, plan.slot_of_elem] = self.indices[:, in_modes].T
        return rows

    def dedup_tables(self, d: int):
        """Per-block factor-row dedup tables for the mode-``d`` layout:
        ``(uidx (N-1, S_d), upos (S_d, N-1), nuniq (N-1, nblocks))`` int32
        over the input modes ``w != d`` in ascending order. Memoized."""
        cached = self._dedup_cache.get(d)
        if cached is None:
            with _obs_span("plan.dedup_tables", mode=d):
                plan = self.plans[d]
                uidx, upos, nuniq = _dedup_tables_batched(
                    self._slot_rows(d), plan.nblocks, plan.block_p)
                cached = (uidx, np.ascontiguousarray(upos.T), nuniq)
            self._dedup_cache[d] = cached
        return cached

    def trivial_dedup_tables(self, d: int):
        """Dedup-off tables in the same encoding: every slot stages its own
        row (``upos = slot % P``, ``nuniq = P``, pad slots stage row 0)."""
        plan = self.plans[d]
        nm1 = self.nmodes - 1
        rows = self._slot_rows(d)
        uidx = np.where(rows == _ROW_SENTINEL, 0, rows)
        upos = np.repeat(
            (np.arange(plan.padded_nnz, dtype=np.int32)
             % plan.block_p)[:, None], nm1, axis=1)
        nuniq = np.full((nm1, plan.nblocks), plan.block_p, dtype=np.int32)
        return uidx, upos, nuniq

    def dma_row_model(self, d: int) -> dict:
        """Modeled factor-row copies for the mode-``d`` in-kernel gather:
        per-slot copies (``nblocks * P`` per input factor, what a kernel
        without dedup stages) against per-block-unique copies (``sum
        nuniq``). The ratio is the in-block hot-row re-fetch factor the
        dedup stage removes."""
        plan = self.plans[d]
        nm1 = self.nmodes - 1
        _, _, nuniq = self.dedup_tables(d)
        per_slot = plan.nblocks * plan.block_p * nm1
        return {
            "per_slot_rows": int(per_slot),
            "dedup_rows": int(nuniq.sum()),
            "dedup_reduction_x": float(per_slot / max(int(nuniq.sum()), 1)),
        }

    def memory_bits_per_element(self, float_bits: int = 32) -> float:
        """Paper Sec. 3.5.1: N*log2(|X|) + sum_h log2(I_h) + delta_float."""
        n = self.nmodes
        return (
            n * math.log2(max(self.nnz, 2))
            + sum(math.log2(max(i, 2)) for i in self.dims)
            + float_bits
        )


def build_flycoo(
    indices: np.ndarray,
    values: np.ndarray,
    dims: Sequence[int],
    kappa: int | Sequence[int] | None = None,
    rows_pp: int | None = None,
    block_p: int = 128,
    schedule: str = DEFAULT_SCHEDULE,
    degrees: Sequence[np.ndarray] | None = None,
    plans: Sequence[ModePlan] | None = None,
) -> FlycooTensor:
    """Preprocess a COO tensor into FLYCOO format (paper Sec. 5.7 cost:
    O(nnz log nnz) per mode, touching only nonzeros).

    ``kappa`` may be per-mode (a sequence). ``degrees`` (per-mode
    ``bincount`` vectors) lets the plan cache hand down the histograms it
    already computed; ``plans`` skips :func:`plan_mode` entirely (the
    cache-hit path: the caller guarantees the plans match this element
    list, so the index range scan is skipped too).
    """
    indices = np.ascontiguousarray(np.asarray(indices, dtype=np.int32))
    values = np.ascontiguousarray(np.asarray(values, dtype=np.float32))
    if indices.ndim != 2 or indices.shape[0] != values.shape[0]:
        raise ValueError(f"indices {indices.shape} / values {values.shape}")
    n = indices.shape[1]
    if len(dims) != n or n < 3:
        raise ValueError("the paper targets tensors of mode >= 3 with one "
                         f"dim per index column; got dims {tuple(dims)}")
    if plans is not None:
        if len(plans) != n:
            raise ValueError(f"{len(plans)} plans for {n} modes")
        return FlycooTensor(tuple(int(x) for x in dims), indices, values,
                            list(plans))
    idx_t = np.ascontiguousarray(indices.T)
    for d in range(n):
        if idx_t[d].min(initial=0) < 0 or idx_t[d].max(initial=0) >= dims[d]:
            raise ValueError(f"mode-{d} index out of [0, {dims[d]})")
    kappas = ([kappa] * n if kappa is None or np.isscalar(kappa)
              else list(kappa))
    plans = []
    for d in range(n):
        with _obs_span("plan.mode", mode=d, nnz=int(values.shape[0])):
            plans.append(plan_mode(
                idx_t[d], int(dims[d]), d, kappa=kappas[d], rows_pp=rows_pp,
                block_p=block_p, schedule=schedule,
                degrees=None if degrees is None else degrees[d]))
    return FlycooTensor(tuple(int(x) for x in dims), indices, values, plans)
