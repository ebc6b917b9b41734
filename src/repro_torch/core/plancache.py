"""Host-side plan cache keyed on a tensor sparsity signature.

The port's copy of ``repro.core.plancache``. ``build_flycoo`` pays a
degree sort plus a partition sort over the nonzeros in every mode; when
the same tensor, or a reordering of it, is planned again, this cache
serves the plans back at three levels:

``hit`` (identity)
    The same element list (bitwise-equal ``indices``) was planned before
    under the same knobs: the cached plans are returned verbatim.

``structural`` (signature)
    A *permutation* of a planned tensor (same per-mode degree vectors,
    another element order): the degree sort, the cyclic deal, the
    relabeling and the block layout are reused and only ``slot_of_elem``
    is rebuilt (:func:`~repro_torch.core.partition.plan_from_structure`),
    bitwise-equal to a cold plan of the reordered list.

``miss``
    Cold :func:`~repro_torch.core.flycoo.build_flycoo`, handed the
    per-mode degree histograms the cache computed for its signature.

The **sparsity signature** is ``(dims, nnz, per-mode histogram of
floor(log2(degree)))``: invariant under element order and cheap to
compare; a structural hit is then verified by exact per-mode degree
equality before any plan is reused.

With ``path=`` the cache also keeps content-addressed, checksummed npz
blobs on disk, verified with ``resilience.snapshot.payload_digest``; a
blob that fails its checksum is renamed ``*.corrupt`` and the lookup
falls through to a cold plan (the ``corrupt_blob`` chaos fault tears a
blob just after it lands, to exercise this).

A fourth, structural tier memoizes the streaming tier's chunk plans
(:meth:`PlanCache.get_stream_plan`, keyed by
``engine.stream._stream_plan_key``): a re-init of the same tensor under
the same chunk-sizing knobs reuses its ``StreamPlan``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Sequence

import numpy as np

from repro_torch.obs.metrics import counter as _obs_counter
from repro_torch.obs.trace import span as _obs_span
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.snapshot import payload_digest

from .flycoo import FlycooTensor, build_flycoo
from .partition import ModePlan, plan_from_structure


def sparsity_signature(
    indices: np.ndarray,
    dims: Sequence[int],
    degrees: Sequence[np.ndarray] | None = None,
) -> tuple:
    """Permutation-invariant sparsity signature of a COO tensor:
    ``(dims, nnz, per-mode histogram of floor(log2(degree)))`` as a
    hashable nested tuple. Tensors that differ in dims, nnz or any mode's
    quantized degree histogram differ here; equal signatures are only a
    candidate match."""
    indices = np.asarray(indices)
    nnz, n = indices.shape
    if degrees is None:
        degrees = [np.bincount(indices[:, d], minlength=int(dims[d]))
                   for d in range(n)]
    hists = []
    for d in range(n):
        deg = degrees[d]
        pos = deg[deg > 0]
        buckets = np.bincount(
            np.log2(pos.astype(np.float64)).astype(np.int64), minlength=1)
        hists.append(tuple(int(c) for c in buckets))
    return (tuple(int(x) for x in dims), int(nnz), tuple(hists))


def _blob_payload_order(arrays: dict, nmodes: int) -> dict:
    """The array order the disk-blob digest is computed over, the same at
    save and load time whatever the npz member order."""
    ordered = {"indices": arrays["indices"], "meta": arrays["meta"]}
    for d in range(nmodes):
        for part in ("relabel", "slot", "partnnz", "bpart"):
            ordered[f"{part}{d}"] = arrays[f"{part}{d}"]
    return ordered


def _count(outcome: str) -> None:
    _obs_counter("plan_cache_outcomes",
                 "plan cache lookups by level (hit/structural/miss)"
                 ).inc(outcome)


@dataclasses.dataclass
class _Entry:
    """One cached element list: its indices (identity compare), per-mode
    degrees (structural check, cold-path hand-down) and plans per knob
    setting."""

    indices: np.ndarray                       # (nnz, N) int32 canonical
    degrees: list[np.ndarray]                 # per-mode bincounts
    hist_key: tuple                           # quantized-histogram part
    plans: dict[tuple, list[ModePlan]]        # knob key -> per-mode plans


class PlanCache:
    """In-process plan cache; see the module docstring for the levels.

    ``get_tensor`` is a drop-in for :func:`build_flycoo`; ``last_outcome``
    (``"hit" | "structural" | "miss"``) and :meth:`stats` report what it
    did. Entries are evicted first in, first out past ``max_entries``.

    With ``path=<dir>`` every cold plan is also written as an npz blob
    named by a sha256 of dims/nnz/knobs and the exact per-mode degree
    vectors (tmp file, then rename), and an in-memory miss loads the blob
    before planning again. A disk load counts as ``hit`` (stored element
    list bitwise-equal) or ``structural`` (same degrees, new order);
    ``disk_loads``/``disk_saves``/``disk_corrupt`` count the traffic.
    """

    def __init__(self, max_entries: int = 32, path: str | None = None):
        self.max_entries = max_entries
        self.path = os.fspath(path) if path is not None else None
        self._by_key: dict[tuple, list[_Entry]] = {}
        self._order: list[tuple] = []          # FIFO eviction
        self.hits = 0
        self.structural_hits = 0
        self.misses = 0
        self.disk_loads = 0
        self.disk_saves = 0
        self.disk_corrupt = 0
        self.stream_hits = 0
        self.stream_misses = 0
        self._stream_plans: dict = {}
        self.last_outcome: str | None = None

    # ------------------------------------------------------------------ api
    def get_tensor(
        self,
        indices: np.ndarray,
        values: np.ndarray,
        dims: Sequence[int],
        kappa: int | Sequence[int] | None = None,
        rows_pp: int | None = None,
        block_p: int = 128,
        schedule: str = "compact",
    ) -> FlycooTensor:
        with _obs_span("plan.cache_lookup") as sp:
            t = self._get_tensor(indices, values, dims, kappa=kappa,
                                 rows_pp=rows_pp, block_p=block_p,
                                 schedule=schedule)
            sp.set("outcome", self.last_outcome)
            _count(self.last_outcome)
            return t

    def _get_tensor(self, indices, values, dims, *, kappa, rows_pp, block_p,
                    schedule) -> FlycooTensor:
        indices = np.ascontiguousarray(np.asarray(indices, dtype=np.int32))
        dims_t = tuple(int(x) for x in dims)
        nnz = int(indices.shape[0])
        key = (dims_t, nnz)
        knob_kappa = (kappa if kappa is None or np.isscalar(kappa)
                      else tuple(int(k) for k in kappa))
        knobs = (knob_kappa, rows_pp, int(block_p), schedule)
        entries = self._by_key.get(key, [])

        # -- level 1: identity hit (bitwise-equal element list) ----------
        for e in entries:
            if e.indices is indices or np.array_equal(e.indices, indices):
                plans = e.plans.get(knobs)
                if plans is not None:
                    self.hits += 1
                    self.last_outcome = "hit"
                    return build_flycoo(indices, values, dims_t,
                                        plans=plans)
                # known structure under new knobs: try disk, else plan
                # cold reusing the degree histograms
                t = self._disk_load(indices, values, dims_t, knobs,
                                    e.degrees, schedule)
                if t is None:
                    t = build_flycoo(indices, values, dims_t, kappa=kappa,
                                     rows_pp=rows_pp, block_p=block_p,
                                     schedule=schedule, degrees=e.degrees)
                    self._disk_save(t, knobs, e.degrees)
                    self.misses += 1
                    self.last_outcome = "miss"
                e.plans[knobs] = t.plans
                return t

        # -- level 2: structural hit (same degrees, new element order) ---
        idx_t = np.ascontiguousarray(indices.T)
        degrees = [np.bincount(idx_t[d], minlength=dims_t[d])
                   for d in range(indices.shape[1])]
        _, _, hist_key = sparsity_signature(indices, dims_t,
                                            degrees=degrees)
        for e in entries:
            if e.hist_key != hist_key or not all(
                    np.array_equal(a, b) for a, b in zip(e.degrees, degrees)):
                continue
            base = e.plans.get(knobs)
            if base is None:
                continue
            plans = [plan_from_structure(idx_t[d], base[d])
                     for d in range(indices.shape[1])]
            self._insert(key, _Entry(indices, e.degrees, hist_key,
                                     {knobs: plans}))
            self.structural_hits += 1
            self.last_outcome = "structural"
            return build_flycoo(indices, values, dims_t, plans=plans)

        # -- level 2.5: disk blob (persisted by an earlier process) ------
        t = self._disk_load(indices, values, dims_t, knobs, degrees,
                            schedule)
        if t is None:
            # -- level 3: miss (cold plan; degrees handed down) ----------
            t = build_flycoo(indices, values, dims_t, kappa=kappa,
                             rows_pp=rows_pp, block_p=block_p,
                             schedule=schedule, degrees=degrees)
            self._disk_save(t, knobs, degrees)
            self.misses += 1
            self.last_outcome = "miss"
        self._insert(key, _Entry(t.indices, degrees, hist_key,
                                 {knobs: t.plans}))
        return t

    def get_stream_plan(self, key: str, builder):
        """Structural tier for streamed chunk plans: ``key`` digests the
        plan geometry and the chunk-sizing knobs
        (``engine.stream._stream_plan_key``); ``builder`` runs on a miss.
        A re-init of the same tensor under the same budget returns the
        memoized (frozen) ``StreamPlan``. Outcomes land on the
        ``stream_replan_outcomes`` obs counter."""
        plan = self._stream_plans.get(key)
        outcome = "hit" if plan is not None else "miss"
        if plan is None:
            plan = builder()
            self._stream_plans[key] = plan
            self.stream_misses += 1
        else:
            self.stream_hits += 1
        _obs_counter(
            "stream_replan_outcomes",
            "streamed chunk-plan lookups by level (hit/miss)",
        ).inc(outcome)
        return plan

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "structural_hits": self.structural_hits,
            "misses": self.misses,
            "disk_loads": self.disk_loads,
            "disk_saves": self.disk_saves,
            "disk_corrupt": self.disk_corrupt,
            "stream_hits": self.stream_hits,
            "stream_misses": self.stream_misses,
            "entries": sum(len(v) for v in self._by_key.values()),
        }

    def clear(self) -> None:
        self._by_key.clear()
        self._order.clear()
        self._stream_plans.clear()

    # ------------------------------------------------------- disk persistence
    def _disk_key(self, dims_t: tuple, nnz: int, knobs: tuple,
                  degrees: Sequence[np.ndarray]) -> str:
        """Content address: dims/nnz/knobs plus the exact per-mode degree
        vectors, so permutations of one tensor share a blob."""
        h = hashlib.sha256()
        h.update(repr((dims_t, nnz, knobs)).encode())
        for deg in degrees:
            h.update(np.ascontiguousarray(deg, dtype=np.int64).tobytes())
        return h.hexdigest()

    def _disk_load(self, indices, values, dims_t, knobs, degrees,
                   schedule) -> FlycooTensor | None:
        """Plans from a persisted blob, as an identity hit (stored element
        list bitwise-equal) or a structural one (``slot_of_elem`` rebuilt
        for the new order). A blob that fails to parse or to verify
        against its digest is quarantined and ``None`` returned."""
        if self.path is None:
            return None
        fn = os.path.join(
            self.path,
            self._disk_key(dims_t, len(indices), knobs, degrees) + ".npz")
        if not os.path.exists(fn):
            return None
        try:
            with np.load(fn) as blob:
                arrays = {name: blob[name] for name in blob.files}
            stored_idx = arrays["indices"]
            meta = arrays["meta"]
            stored_digest = bytes(arrays["digest"]).decode()
            ordered = _blob_payload_order(arrays, len(dims_t))
            if payload_digest(ordered) != stored_digest:
                raise ValueError(f"plan blob digest mismatch: {fn}")
            plans = []
            for d in range(indices.shape[1]):
                kappa, rows_pp, block_p, blocks_pp, dim, nblocks, \
                    max_degree = (int(x) for x in meta[d])
                plans.append(ModePlan(
                    mode=d, kappa=kappa, rows_pp=rows_pp, block_p=block_p,
                    blocks_pp=blocks_pp, dim=dim, schedule=schedule,
                    nblocks=nblocks, row_relabel=arrays[f"relabel{d}"],
                    slot_of_elem=arrays[f"slot{d}"],
                    part_nnz=arrays[f"partnnz{d}"],
                    block_part=arrays[f"bpart{d}"], max_degree=max_degree))
        except Exception:
            self._quarantine(fn)
            return None
        self.disk_loads += 1
        if np.array_equal(stored_idx, indices):
            self.hits += 1
            self.last_outcome = "hit"
        else:
            idx_t = np.ascontiguousarray(indices.T)
            plans = [plan_from_structure(idx_t[d], plans[d])
                     for d in range(indices.shape[1])]
            self.structural_hits += 1
            self.last_outcome = "structural"
        return build_flycoo(indices, values, dims_t, plans=plans)

    def _disk_save(self, t: FlycooTensor, knobs: tuple,
                   degrees: Sequence[np.ndarray]) -> None:
        """Persist a cold plan: content-addressed npz written to a tmp
        file in the same directory, then renamed, with the payload digest
        embedded so :meth:`_disk_load` can verify it."""
        if self.path is None:
            return
        os.makedirs(self.path, exist_ok=True)
        key = self._disk_key(t.dims, t.nnz, knobs, degrees)
        fn = os.path.join(self.path, key + ".npz")
        if os.path.exists(fn):
            return
        arrays = {"indices": t.indices,
                  "meta": np.asarray(
                      [[p.kappa, p.rows_pp, p.block_p, p.blocks_pp, p.dim,
                        p.nblocks, p.max_degree] for p in t.plans],
                      dtype=np.int64)}
        for d, p in enumerate(t.plans):
            arrays[f"relabel{d}"] = p.row_relabel
            arrays[f"slot{d}"] = p.slot_of_elem
            arrays[f"partnnz{d}"] = p.part_nnz
            arrays[f"bpart{d}"] = p.block_part
        digest = payload_digest(_blob_payload_order(arrays, t.nmodes))
        arrays["digest"] = np.frombuffer(digest.encode(), dtype=np.uint8)
        tmp = os.path.join(self.path, f".tmp-{os.getpid()}-{key}")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, fn)
        self.disk_saves += 1
        cz = _chaos.active()
        if cz is not None:
            cz.on_disk_save(fn)

    def _quarantine(self, fn: str) -> None:
        """Move a corrupt blob aside (``*.corrupt``) so the cold plan's
        fresh save can land in its place."""
        self.disk_corrupt += 1
        _count("disk_corrupt")
        with _obs_span("plan.cache_quarantine", path=os.path.basename(fn)):
            try:
                os.replace(fn, fn + ".corrupt")
            except OSError:
                pass

    # ------------------------------------------------------------- internal
    def _insert(self, key: tuple, entry: _Entry) -> None:
        self._by_key.setdefault(key, []).append(entry)
        self._order.append(key)
        while len(self._order) > self.max_entries:
            old = self._order.pop(0)
            bucket = self._by_key.get(old)
            if bucket:
                bucket.pop(0)
                if not bucket:
                    del self._by_key[old]


#: Process-wide default cache (``engine.make_engine`` uses it unless handed
#: an explicit one).
DEFAULT_CACHE = PlanCache()


def cached_build_flycoo(indices, values, dims, **knobs) -> FlycooTensor:
    """:func:`build_flycoo` through :data:`DEFAULT_CACHE`."""
    return DEFAULT_CACHE.get_tensor(indices, values, dims, **knobs)


__all__ = ["PlanCache", "DEFAULT_CACHE", "cached_build_flycoo",
           "sparsity_signature", "payload_digest"]
