"""Cost-model-guided plan autotuner over a :class:`~repro_torch.engine.
factory.PlanSpace` (the port of ``repro.engine.autotune``).

1. **Analytic stage** (:func:`analytic_cost`): a closed-form cost from the
   per-mode degree histograms only, with no plans built. It simulates
   Alg. 1's cyclic deal from the sorted degrees, prices pad slots from the
   block schedule, models in-block factor-row copies with a collision
   model (``E[uniques/block] = sum_r 1-(1-p_r)^P``), and adds the
   imbalance surplus over the ``OPT >= max(mean, d_max)`` bound. The whole
   space is ranked and cut to ``top_k`` candidates.
2. **Exact stage** (:func:`modeled_cost`): the candidates are planned
   (through the plan cache) and scored on their real pad slots and row
   copies (:meth:`FlycooTensor.dma_row_model`). The default spec is always
   scored here, so the pick is never worse than it on modeled cost.
3. **Measured stage** (optional, :func:`hill_climb`): a greedy
   hypothesis -> change -> measure loop over single-knob neighbours with a
   caller-given ``measure``. Ties break by a seeded draw, so a fixed seed
   reproduces the whole run.

Costs are in slot units (one f32 element move). A spec that resolves to
the streaming tier adds its transfer traffic (chunk uploads and remap
fragments, :func:`repro_torch.engine.stream.stream_transfer_model`), as
the reference prices it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.obs.trace import span

from .factory import SPACE_DIMS, PlanSpace, PlanSpec


def _needs_dedup_tables(spec: PlanSpec) -> bool:
    from .backends import get_backend

    return (spec.schedule == "compact"
            and getattr(get_backend(spec.backend), "needs_dedup", False))


def _mode_degrees(indices: np.ndarray, dims: Sequence[int]) -> list:
    idx_t = np.ascontiguousarray(np.asarray(indices, dtype=np.int32).T)
    return [np.bincount(idx_t[d], minlength=int(dims[d]))
            for d in range(len(dims))]


# --------------------------------------------------------------------------
# Streaming transfer term (chunk uploads + remap fragments per mode).
#
# Transfer bytes divide by 4 to land in slot units, plus ``block_p`` slots
# of launch and ring-turnaround overhead per chunk, so that the tuner
# never picks tiny chunks.
# --------------------------------------------------------------------------
def _analytic_stream_cost(spec: PlanSpec, config, dims, nnz: int,
                          mode_nblocks: Sequence[int]) -> float:
    """Histogram-stage streaming transfer cost: the reference's
    ``stream_transfer_model`` with chunk counts approximated from the
    modeled block totals (no plans built)."""
    from .stream import bytes_per_slot, resolve_chunk_slots, row_bytes

    n = len(dims)
    tables = _needs_dedup_tables(spec) and spec.dedup
    target = resolve_chunk_slots(config, dims, tables=tables)
    target_blocks = max(1, target // spec.block_p)
    total = 0.0
    for nblocks in mode_nblocks:
        nchunks = max(1, -(-int(nblocks) // target_blocks))
        upload_slots = int(nblocks) * spec.block_p
        total += upload_slots * bytes_per_slot(n, tables) / 4.0
        total += nnz * row_bytes(n) / 4.0          # remap fragment per hop
        total += nchunks * spec.block_p            # per-chunk overhead
    return total


def _analytic_streams(spec: PlanSpec, config, dims, nnz: int,
                      mode_nblocks: Sequence[int]) -> bool:
    """Whether this spec runs the streaming tier, ``"auto"`` resolved
    against a histogram-stage estimate of the resident footprint."""
    if spec.residency == "stream":
        return True
    if spec.residency != "auto" or config.device_budget_bytes is None:
        return False
    n = len(dims)
    smax = max(int(b) for b in mode_nblocks) * spec.block_p
    resident = smax * 4 * (1 + 2 * n)
    tables = _needs_dedup_tables(spec) and spec.dedup
    for nblocks in mode_nblocks:
        s_d = int(nblocks) * spec.block_p
        resident += int(nblocks) * 4
        if tables:
            resident += s_d * 8 * (n - 1) + int(nblocks) * 4 * (n - 1)
    resident += sum(int(d) for d in dims) * 4 * (1 + spec.rank_hint)
    resident += max(int(d) for d in dims) * spec.rank_hint * 4
    return resident > config.device_budget_bytes


def _spec_streams(spec: PlanSpec, tensor) -> bool:
    """Exact-stage residency resolution: the rule of
    ``factory.make_engine`` (``resident_bytes`` against the budget)."""
    from .stream import resident_bytes

    if spec.residency == "stream":
        return True
    config = spec.to_config()
    return (spec.residency == "auto"
            and config.device_budget_bytes is not None
            and resident_bytes(tensor, config) > config.device_budget_bytes)


# --------------------------------------------------------------------------
# Stage 1: analytic cost from degree histograms only.
# --------------------------------------------------------------------------
def analytic_cost(degrees: Sequence[np.ndarray], dims: Sequence[int],
                  nnz: int, spec: PlanSpec) -> float:
    """Histogram-only plan cost (slot units): pad slots + modeled factor-
    row copies + imbalance surplus over the OPT lower bound, plus the
    modeled transfer traffic when the spec resolves to the streaming
    tier. No plans built."""
    spec = spec.canonical()
    config = spec.to_config()
    n = len(dims)
    p_blk = spec.block_p
    dedup = _needs_dedup_tables(spec) and spec.dedup
    total = 0.0
    mode_nblocks = []
    # per-factor expected unique rows per block (collision model)
    uniq_per_block = []
    for w in range(n):
        p = degrees[w].astype(np.float64) / max(nnz, 1)
        uniq_per_block.append(float((1.0 - (1.0 - p) ** p_blk).sum()))
    for d in range(n):
        dim = int(dims[d])
        kappa = config.kappa_for(dim, n)
        deg = np.sort(degrees[d].astype(np.int64))[::-1]
        pad = (-dim) % kappa
        if pad:
            deg = np.concatenate([deg, np.zeros(pad, dtype=deg.dtype)])
        part_nnz = deg.reshape(-1, kappa).sum(axis=0)
        blocks = np.maximum(1, -(-part_nnz // p_blk))
        if spec.schedule == "rect":
            nblocks = kappa * int(blocks.max())
        else:
            nblocks = int(blocks.sum())
        mode_nblocks.append(nblocks)
        pad_slots = nblocks * p_blk - nnz
        # imbalance surplus of the achieved max load over the OPT bound
        opt_lb = max(float(part_nnz.mean()), float(deg[0]))
        surplus = float(part_nnz.max()) - opt_lb
        if dedup:
            dma = sum(min(uniq_per_block[w], p_blk) * nblocks
                      for w in range(n) if w != d)
        else:
            dma = (n - 1) * nblocks * p_blk
        total += pad_slots + dma + surplus
    if _analytic_streams(spec, config, dims, nnz, mode_nblocks):
        total += _analytic_stream_cost(spec, config, dims, nnz,
                                       mode_nblocks)
    return float(total)


# --------------------------------------------------------------------------
# Stage 2: exact modeled cost from built plans.
# --------------------------------------------------------------------------
def modeled_cost(tensor, spec: PlanSpec) -> float:
    """Exact modeled cost of ``tensor``'s built plans under ``spec``: pad
    slots + factor-row copies (the dedup tables' unique rows when the spec
    uses them, one per slot otherwise), plus the streamed transfer
    traffic (:func:`repro_torch.engine.stream.stream_transfer_model`) when
    the spec resolves to the streaming tier."""
    spec = spec.canonical()
    dedup = _needs_dedup_tables(spec) and spec.dedup
    total = 0.0
    for d in range(tensor.nmodes):
        plan = tensor.plans[d]
        total += plan.padded_nnz - tensor.nnz
        if dedup:
            total += tensor.dma_row_model(d)["dedup_rows"]
        else:
            total += (tensor.nmodes - 1) * plan.padded_nnz
    if _spec_streams(spec, tensor):
        from .stream import stream_transfer_model

        model = stream_transfer_model(tensor, spec.to_config())
        total += (model["h2d_bytes"] + model["fragment_bytes"]) / 4.0
        total += model["total_chunks"] * spec.block_p
    return float(total)


# --------------------------------------------------------------------------
# Stage 3: measured greedy hill-climb (hypothesis -> change -> measure).
# --------------------------------------------------------------------------
def hill_climb(start: PlanSpec, candidates: Sequence[PlanSpec],
               measure: Callable[[PlanSpec], float], *,
               seed: int = 0, max_steps: int = 8):
    """Greedy single-knob descent over ``candidates``.

    From ``start``, measure every candidate differing in exactly one
    searchable knob, move to the best strict improvement, repeat. Each
    spec is measured once (memoized); equal measurements tie-break by a
    seeded draw, so a fixed seed reproduces the trajectory. Returns
    ``(best_spec, trace)``, ``trace`` recording every step.
    """
    rng = np.random.default_rng(seed)
    cand = list(dict.fromkeys(c.canonical() for c in candidates))
    seen: dict[PlanSpec, float] = {}

    def timed(spec: PlanSpec) -> float:
        if spec not in seen:
            seen[spec] = float(measure(spec))
        return seen[spec]

    current = start.canonical()
    cur_t = timed(current)
    trace = [{"step": 0, "spec": current, "time": cur_t, "move": "start"}]
    for step in range(1, max_steps + 1):
        neighbors = [
            c for c in cand if c != current
            and sum(getattr(c, f) != getattr(current, f)
                    for f in SPACE_DIMS) == 1
        ]
        if not neighbors:
            break
        best, best_t = None, cur_t
        for c in neighbors:
            t = timed(c)
            # strict improvement moves; exact ties resolved by seeded coin
            if t < best_t or (t == best_t and best is not None
                              and rng.integers(2) == 1):
                best, best_t = c, t
        if best is None:
            break
        trace.append({"step": step, "spec": best, "time": best_t,
                      "move": _diff(current, best)})
        current, cur_t = best, best_t
    return current, trace


def _diff(a: PlanSpec, b: PlanSpec) -> str:
    parts = [f"{f}: {getattr(a, f)!r} -> {getattr(b, f)!r}"
             for f in SPACE_DIMS if getattr(a, f) != getattr(b, f)]
    return "; ".join(parts) or "none"


# --------------------------------------------------------------------------
# The tuner.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AutotuneResult:
    best: PlanSpec                       # winner (modeled or measured)
    default: PlanSpec                    # the hand-set baseline point
    analytic: dict                       # spec -> stage-1 cost (full space)
    modeled: dict                        # spec -> stage-2 cost (candidates)
    measured: dict                       # spec -> measure() (measured stage)
    trace: list                          # hill-climb trajectory
    seed: int

    def summary(self) -> dict:
        return {
            "best": dataclasses.asdict(self.best),
            "modeled_best": min(self.modeled.values()),
            "modeled_default": self.modeled[self.default],
            "n_analytic": len(self.analytic),
            "n_exact": len(self.modeled),
            "n_measured": len(self.measured),
            "seed": self.seed,
        }


def autotune(indices, values, dims,
             space: PlanSpace | None = None, *,
             top_k: int = 4,
             measure: Callable[[PlanSpec], float] | None = None,
             seed: int = 0,
             cache=None,
             max_steps: int = 8) -> AutotuneResult:
    """Pick a plan spec for a COO tensor; see the module docstring for the
    stages.

    ``measure`` (optional) maps a spec to a time; when given, a seeded
    greedy hill-climb over the analytic top-``top_k`` runs after the exact
    stage, from its pick; otherwise the exact modeled cost decides, and
    the pick is never worse than the default (``space.base``) on it.
    Candidates are planned as ``make_engine`` plans them, through
    ``cache`` (a fresh :class:`~repro_torch.core.plancache.PlanCache` when
    not given), so a ``measure`` that builds engines through the same
    cache plans nothing twice. Deterministic for a fixed ``seed``.
    """
    from repro_torch.core.plancache import PlanCache

    from .api import as_flycoo

    space = space or PlanSpace()
    if cache is None:
        cache = PlanCache()
    indices = np.ascontiguousarray(np.asarray(indices, dtype=np.int32))
    nnz = int(indices.shape[0])
    with span("autotune", nnz=nnz, top_k=top_k,
              measured=measure is not None) as tune_sp:
        degrees = _mode_degrees(indices, dims)

        specs = space.specs()
        with span("autotune.analytic", space_size=len(specs)):
            analytic = {s: analytic_cost(degrees, dims, nnz, s)
                        for s in specs}
        ranked = sorted(specs, key=lambda s: (analytic[s], specs.index(s)))
        default = space.base.canonical()
        candidates = list(dict.fromkeys(
            [default] + ranked[:max(1, top_k)]))

        modeled = {}
        with span("autotune.exact", candidates=len(candidates)):
            for s in candidates:
                t = as_flycoo((indices, values, dims), s.to_config(),
                              cache=cache)
                modeled[s] = modeled_cost(t, s)
        best = min(candidates,
                   key=lambda s: (modeled[s], candidates.index(s)))

        measured: dict = {}
        trace: list = []
        if measure is not None:
            def memo_measure(spec: PlanSpec) -> float:
                with span("autotune.measure", backend=spec.backend,
                          schedule=spec.schedule, block_p=spec.block_p):
                    t = float(measure(spec))
                measured[spec] = t
                return t

            with span("autotune.hill_climb", max_steps=max_steps):
                best, trace = hill_climb(best, candidates, memo_measure,
                                         seed=seed, max_steps=max_steps)
        tune_sp.set("n_measured", len(measured))

        return AutotuneResult(best=best, default=default, analytic=analytic,
                              modeled=modeled, measured=measured,
                              trace=trace, seed=seed)


__all__ = ["analytic_cost", "modeled_cost", "hill_climb", "autotune",
           "AutotuneResult"]
