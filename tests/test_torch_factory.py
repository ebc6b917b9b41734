"""The port's plan cache, factory and autotuner against the reference's.

Host-side results are compared exactly: sparsity signatures, cache
outcomes and plans (bitwise), the enumerated plan space (under the name
map below), and the analytic and modeled costs. Engines built by
``make_engine`` run on the CPU, where every kernel wrapper runs its plain
version; their outputs are compared bitwise across cold, missed and hit
plans, and with rtol = atol = 2e-5 across plan knobs and backends (the
reference's own factory tests: float32 sums in another order).

Name map (reference -> port): backends ``xla -> torch``, ``pallas ->
cuda``, ``pallas_fused -> cuda_fused``; ``vmem_budget_bytes ->
smem_budget_bytes``. With ``rows_pp`` pinned and ``min_partitions=1`` the
port's ``"smem"`` kappa policy plans the reference's partitions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import datasets as rdatasets
from repro.core.plancache import PlanCache as RPlanCache
from repro.core.plancache import sparsity_signature as rsignature
from repro.engine import PlanSpace as RPlanSpace
from repro.engine import PlanSpec as RPlanSpec
from repro.engine.autotune import analytic_cost as ranalytic
from repro.engine.autotune import modeled_cost as rmodeled
from repro_torch import engine, interop
from repro_torch.core import PlanCache, build_flycoo, sparsity_signature
from repro_torch.engine import PlanSpace, PlanSpec, make_engine
from repro_torch.engine.autotune import (_mode_degrees, analytic_cost,
                                         autotune, modeled_cost)
from repro_torch.engine.config import SMEM_PER_BLOCK
from repro_torch.obs import trace

BACKEND = {"xla": "torch", "pallas": "cuda", "pallas_fused": "cuda_fused",
           "ref": "ref"}
TOL = dict(rtol=2e-5, atol=2e-5)


def _coo(seed=0, dims=(60, 50, 40), nnz=2500, a=1.5):
    t = rdatasets.zipf_tensor(dims, nnz, a=a, seed=seed)
    return t.indices, t.values, t.dims


def _assert_plans_equal(pa, pb):
    for a, b in zip(pa, pb):
        assert (a.kappa, a.rows_pp, a.block_p, a.schedule, a.nblocks,
                a.blocks_pp, a.max_degree) == \
               (b.kappa, b.rows_pp, b.block_p, b.schedule, b.nblocks,
                b.blocks_pp, b.max_degree)
        for f in ("row_relabel", "slot_of_elem", "part_nnz", "block_part"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _spec(**kw):
    return PlanSpec(device="cpu", **kw)


def _factors(dims, seed, rank=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, rank)).astype(np.float32) for d in dims]


# --------------------------------------------------------------------------
# Sparsity signature and the plan cache.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,a", [(0, 1.5), (3, 2.2), (7, 1.1)])
def test_signature_equals_reference_and_ignores_order(seed, a):
    idx, _, dims = _coo(seed=seed, a=a)
    perm = np.random.default_rng(seed).permutation(len(idx))
    sig = sparsity_signature(idx, dims)
    assert sig == rsignature(idx, dims) == sparsity_signature(idx[perm],
                                                              dims)
    assert sig != sparsity_signature(idx, (dims[0] + 1,) + dims[1:])
    assert sig != sparsity_signature(idx[:-1], dims)


@pytest.mark.parametrize("schedule", ["compact", "rect"])
def test_cache_levels_and_plans_equal_reference(schedule):
    """Cold, identity-hit, structural-hit and changed-sparsity lookups:
    the same outcomes as the reference's cache, plans bitwise equal to
    its plans and to fresh ones."""
    idx, val, dims = _coo(seed=5)
    perm = np.random.default_rng(5).permutation(len(idx))
    mut = idx.copy()
    mut[0, 0] = (mut[0, 0] + 1) % dims[0]
    lookups = [(idx, val), (idx.copy(), val), (idx[perm], val[perm]),
               (mut, val)]
    tc, rc = PlanCache(), RPlanCache()
    kw = dict(rows_pp=8, block_p=16, schedule=schedule)
    for (i, v), want in zip(lookups, ("miss", "hit", "structural", "miss")):
        t = tc.get_tensor(i, v, dims, **kw)
        r = rc.get_tensor(i, v, dims, **kw)
        assert tc.last_outcome == rc.last_outcome == want
        _assert_plans_equal(t.plans, r.plans)
        _assert_plans_equal(t.plans, build_flycoo(i, v, dims, **kw).plans)
    assert tc.stats() == rc.stats()


def test_cache_knob_key_and_eviction():
    idx, val, dims = _coo()
    cache = PlanCache()
    a = cache.get_tensor(idx, val, dims, block_p=32)
    b = cache.get_tensor(idx, val, dims, block_p=64)
    assert cache.last_outcome == "miss"  # known structure, new knobs
    assert a.plans[0].block_p == 32 and b.plans[0].block_p == 64
    cache.get_tensor(idx, val, dims, block_p=32)
    assert cache.last_outcome == "hit"
    small = PlanCache(max_entries=3)
    for seed in range(6):
        i, v, d = _coo(seed=seed, nnz=400)
        small.get_tensor(i, v, d)
    assert small.stats()["entries"] <= 3


def test_disk_tier_reads_reference_blobs_and_quarantines_torn_ones(tmp_path):
    """A blob the reference's cache wrote loads in the port as a hit (same
    content address, same digest); a permuted list is a structural hit; a
    torn blob is renamed ``*.corrupt`` and planned again, bitwise equal."""
    idx, val, dims = _coo(seed=2)
    kw = dict(rows_pp=8, block_p=16)
    RPlanCache(path=tmp_path).get_tensor(idx, val, dims, **kw)
    [blob] = list(tmp_path.glob("*.npz"))
    fresh = build_flycoo(idx, val, dims, **kw)
    cache = PlanCache(path=tmp_path)
    t = cache.get_tensor(idx, val, dims, **kw)
    assert cache.last_outcome == "hit" and cache.disk_loads == 1
    _assert_plans_equal(t.plans, fresh.plans)
    perm = np.random.default_rng(0).permutation(len(idx))
    cache2 = PlanCache(path=tmp_path)
    t2 = cache2.get_tensor(idx[perm], val[perm], dims, **kw)
    assert cache2.last_outcome == "structural"
    _assert_plans_equal(t2.plans,
                        build_flycoo(idx[perm], val[perm], dims, **kw).plans)
    blob.write_bytes(blob.read_bytes()[:200])
    cache3 = PlanCache(path=tmp_path)
    t3 = cache3.get_tensor(idx, val, dims, **kw)
    assert cache3.last_outcome == "miss" and cache3.disk_corrupt == 1
    assert blob.with_name(blob.name + ".corrupt").exists()
    assert cache3.disk_saves == 1 and blob.exists()
    _assert_plans_equal(t3.plans, fresh.plans)


# --------------------------------------------------------------------------
# PlanSpec / PlanSpace.
# --------------------------------------------------------------------------
def _as_port(rspec):
    return tuple(BACKEND[v] if f == "backend" else
                 SMEM_PER_BLOCK if f == "vmem_budget_bytes" else v
                 for f, v in ((f, getattr(rspec, f))
                              for f in RSPACE_DIMS))


RSPACE_DIMS = ("backend", "schedule", "block_p", "rows_pp",
               "vmem_budget_bytes", "dedup", "fuse_remap", "exchange",
               "residency", "chunk_nnz")


@pytest.mark.parametrize("backends", [("xla", "pallas_fused"),
                                      ("pallas", "pallas_fused", "ref")])
def test_planspace_enumerates_the_reference_points(backends):
    rspace = RPlanSpace(backend=backends, schedule=("compact", "rect"),
                        block_p=(64, 128), dedup=(True, False),
                        fuse_remap=(True, False))
    space = PlanSpace(backend=tuple(BACKEND[b] for b in backends),
                      schedule=("compact", "rect"), block_p=(64, 128),
                      dedup=(True, False), fuse_remap=(True, False),
                      base=_spec())
    got = [tuple(getattr(s, f) for f in engine.SPACE_DIMS)
           for s in space.specs()]
    assert got == [_as_port(s) for s in rspace.specs()]
    assert space.specs() == space.specs() and space.size == len(got)


def test_planspec_validation_and_default_device():
    for bad in (dict(schedule="diagonal"), dict(exchange="broadcast"),
                dict(kappa_policy="fixed"), dict(residency="disk"),
                dict(chunk_nnz=0), dict(stream_ring=0)):
        with pytest.raises(ValueError):
            _spec(**bad)
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlanSpec(backend="cuda")    # runs on the card unless told not to


# --------------------------------------------------------------------------
# Costs and the tuner.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend,schedule,block_p,dedup", [
    ("xla", "compact", 32, True), ("pallas", "rect", 16, True),
    ("pallas_fused", "compact", 64, True),
    ("pallas_fused", "compact", 32, False),
    ("pallas_fused", "rect", 32, True)])
def test_costs_equal_reference(backend, schedule, block_p, dedup):
    idx, val, dims = _coo(seed=1)
    knobs = dict(schedule=schedule, block_p=block_p, rows_pp=12,
                 dedup=dedup)
    rspec = RPlanSpec(backend=backend, **knobs)
    spec = _spec(backend=BACKEND[backend], min_partitions=1, **knobs)
    degrees = _mode_degrees(idx, dims)
    assert analytic_cost(degrees, dims, len(idx), spec) == \
        ranalytic(degrees, dims, len(idx), rspec)
    t = engine.api.as_flycoo((idx, val, dims), spec.to_config())
    rt = rdatasets.build_flycoo(idx, val, dims, rows_pp=12, block_p=block_p,
                                schedule=schedule)
    _assert_plans_equal(t.plans, rt.plans)
    assert modeled_cost(t, spec) == rmodeled(rt, rspec)


def _small_space():
    return PlanSpace(backend=("cuda_fused",), block_p=(16, 32, 64),
                     base=_spec(backend="cuda_fused", rows_pp=16,
                                block_p=32))


def test_autotune_deterministic_and_never_worse_than_default():
    idx, val, dims = _coo(nnz=1200)
    r1 = autotune(idx, val, dims, _small_space(), seed=3)
    r2 = autotune(idx, val, dims, _small_space(), seed=3)
    assert r1.best == r2.best
    assert r1.modeled == r2.modeled and r1.analytic == r2.analytic
    assert r1.default in r1.modeled
    assert r1.modeled[r1.best] <= r1.modeled[r1.default]
    assert len(r1.analytic) == _small_space().size == 9


def test_hill_climb_deterministic_and_traced():
    """A synthetic measure (the analytic cost) gives the climb a
    deterministic landscape with real moves. Candidates that share plan
    knobs (they differ in dedup only) are planned once."""
    idx, val, dims = _coo(nnz=1200)
    space = _small_space()

    def run(seed):
        r0 = autotune(idx, val, dims, space, seed=seed)
        cache = PlanCache()
        r = autotune(idx, val, dims, space, seed=seed, cache=cache,
                     measure=lambda s: r0.analytic.get(s, 1e9))
        return r, cache

    (r1, c1), (r2, _) = run(3), run(3)
    assert r1.best == r2.best
    assert [s["spec"] for s in r1.trace] == [s["spec"] for s in r2.trace]
    assert r1.trace[0]["move"] == "start"
    assert set(r1.measured) <= set(r1.modeled)
    knobs = {(s.block_p, s.schedule) for s in r1.modeled}
    assert c1.stats()["misses"] == len(knobs) < len(r1.modeled)
    assert c1.stats()["hits"] == len(r1.modeled) - len(knobs)


# --------------------------------------------------------------------------
# make_engine.
# --------------------------------------------------------------------------
def test_backends_identical_under_factory_cached_autotuned():
    """Each backend's rotation is bitwise the same from cold, missed and
    hit plans, close under the autotuned knobs, and close to the
    ``torch`` backend."""
    idx, val, dims = _coo()
    factors = interop.factors_from_numpy(_factors(dims, 1), device="cpu")
    tuned = autotune(idx, val, dims, _small_space(), seed=0).best
    outs = {}
    for b in ("torch", "ref", "cuda", "cuda_fused"):
        spec = _spec(backend=b, rows_pp=16, block_p=32)
        cache = PlanCache()
        runs = []
        for cch in (False, cache, cache):   # cold, miss, identity hit
            o, _ = engine.all_modes(make_engine((idx, val, dims), spec,
                                                cache=cch), factors)
            runs.append(o)
        assert cache.last_outcome == "hit"
        o, _ = engine.all_modes(
            make_engine((idx, val, dims),
                        dataclasses.replace(tuned, backend=b), cache=cache),
            factors)
        for d in range(len(dims)):
            assert torch.equal(runs[0][d], runs[1][d])
            assert torch.equal(runs[0][d], runs[2][d])
            np.testing.assert_allclose(runs[0][d].numpy(), o[d].numpy(),
                                       **TOL)
        outs[b] = runs[0]
    for b in ("ref", "cuda", "cuda_fused"):
        for d in range(len(dims)):
            np.testing.assert_allclose(outs["torch"][d].numpy(),
                                       outs[b][d].numpy(), **TOL)


def test_make_engine_plans_like_engine_init_and_reports():
    """Raw COO through the factory equals ``engine.init`` under the
    spec's config; the default cache serves a repeat; the span and the
    cache counter are recorded."""
    from repro_torch.core.plancache import DEFAULT_CACHE
    from repro_torch.obs.metrics import REGISTRY

    idx, val, dims = _coo(seed=4, nnz=800)
    spec = _spec(backend="cuda_fused", schedule="rect", rows_pp=8,
                 block_p=16, fuse_remap=False)
    want = engine.init((idx, val, dims), spec.to_config(), start_mode=2)
    tracer = trace.enable()
    try:
        make_engine((idx, val, dims), spec, start_mode=2)
        got = make_engine((idx, val, dims), spec, start_mode=2)
    finally:
        trace.disable()
    assert DEFAULT_CACHE.last_outcome == "hit"
    assert got.mode == want.mode == 2 and got.statics == want.statics
    for a in ("val", "idx", "alpha"):
        assert torch.equal(getattr(got, a), getattr(want, a))
    names = [s.name for s in tracer.spans()]
    assert names.count("factory.make_engine") == 2
    assert "plan.cache_lookup" in names
    assert REGISTRY.counter("plan_cache_outcomes")["hit"] >= 1


_NOT_A_MESH = "Mesh or a repro_torch.sharding.ShardingCtx"


@pytest.mark.parametrize("call,item", [
    (dict(mesh=object()), _NOT_A_MESH),
    (dict(mesh=object(), ladder=True), _NOT_A_MESH),
    (dict(spec=dict(ladder=True), mesh=object()), _NOT_A_MESH),
    (dict(mesh=object(), resume=object()), _NOT_A_MESH)])
def test_make_engine_refuses_what_is_not_ported(call, item):
    """A mesh that is neither the port's ``launch.mesh.Mesh`` nor a
    ``sharding.ShardingCtx`` raises ``TypeError`` naming both types; no
    ladder and no resume steps over the refusal, and nothing else runs in
    its place. The distributed tier itself is held
    in ``tests/test_torch_dist.py``, the ladder and resume in
    ``tests/test_torch_resilience.py``."""
    idx, val, dims = _coo(nnz=300)
    spec = _spec(backend="cuda_fused", **call.pop("spec", {}))
    with pytest.raises(TypeError, match=item):
        make_engine((idx, val, dims), spec, cache=False, **call)
