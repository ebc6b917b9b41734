"""The port's streaming tier (``repro_torch.engine.stream``) on the CPU,
case by case after the reference's ``tests/test_stream.py``.

Streamed against the port's resident engine, **bitwise**: on the CPU
every kernel wrapper runs its plain version, whose ``index_add_`` sums
each output row in slot order, and a chunk holds whole partitions in the
resident order, so outputs, CPD fits and host layouts agree bit for bit
for all four backends, both schedules, 3 to 6 modes, every start mode
and every chunking. The kernels' own schedule (``chunked_plain*``, the
plain version of a work table) is bitwise too when each chunk's table is
built at the resident mode's cap, and not when it is built at the
chunk's own cap.

Against the reference (``repro.engine.stream``, JAX on the CPU, Pallas
in interpret mode for ``pallas_fused``) from the same numpy inputs and
matching knobs (the same ``rows_pp``, ``min_partitions=1`` or
``kappa_policy="fixed"``): chunk schedules, target slots, the budget
model, the transfer model, the autotuner's stream costs and the host
layouts after each mode exactly equal; outputs within rtol = atol =
2e-4, as ``tests/test_torch_engine.py`` holds the resident engine
(float32 sums in another order).

Every config here has ``device="cpu"``: the default device is the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as rengine
from repro.core import build_flycoo as rbuild
from repro.engine import ExecutionConfig as RConfig
from repro.engine import PlanSpec as RPlanSpec
from repro.engine import stream as rstream
from repro.engine.autotune import analytic_cost as ranalytic
from repro.engine.autotune import modeled_cost as rmodeled
from repro_torch import engine, interop
from repro_torch.core import PlanCache, build_flycoo, cp_als, zipf_tensor
from repro_torch.core.partition import chunk_bpart, chunk_schedule
from repro_torch.engine import (ExecutionConfig, PlanSpec, StreamState,
                                make_engine)
from repro_torch.engine import stream
from repro_torch.engine.autotune import (_mode_degrees, analytic_cost,
                                         modeled_cost)
from repro_torch.engine.stream import (cp_als_stream, plan_stream,
                                       resident_bytes, resolve_chunk_slots,
                                       stream_all_modes, stream_init,
                                       stream_mttkrp, stream_transfer_model)
from repro_torch.kernels import mttkrp as kmt
from repro_torch.resilience import DEFAULT_POLICY

BACKENDS = ("torch", "ref", "cuda", "cuda_fused")
RBACKEND = {"torch": "xla", "ref": "ref", "cuda": "pallas",
            "cuda_fused": "pallas_fused"}
TOL = dict(rtol=2e-4, atol=2e-4)
LAYOUT = ("val", "idx", "alpha", "lrow")


def _coo(nmodes=3, nnz=300, seed=0):
    dims = (29, 23, 19, 13, 11, 7)[:nmodes]
    rng = np.random.default_rng(seed)
    idx = np.unique(np.stack([rng.integers(0, d, nnz) for d in dims], 1)
                    .astype(np.int32), axis=0)
    return idx, rng.standard_normal(len(idx)).astype(np.float32), dims


def _factors(dims, rank=5, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, rank)).astype(np.float32) for d in dims]


def _cfg(**kw):
    return ExecutionConfig(device="cpu", **kw)


def _layout(state, d):
    """The resident state's layout cut to mode ``d``'s slots, with its
    ``lrow``."""
    sd = state.statics[d].padded_nnz
    lay = engine.api.mode_layout(state, (state.val, state.idx, state.alpha),
                                 d)
    return {k: lay[k][:sd].numpy() for k in LAYOUT}


def _assert_stream_matches_resident(config, t, facs, start_mode=0):
    """One rotation each: outputs bitwise, and the streamed host layout
    after every mode bitwise the resident layout's first S_d slots."""
    tf = interop.factors_from_numpy(facs, device="cpu")
    st = engine.init(t, config, start_mode=start_mode)
    ss = stream_init(t, config, start_mode=start_mode)
    for _ in range(t.nmodes):
        d = st.mode
        want = _layout(st, d)
        for k in LAYOUT:
            np.testing.assert_array_equal(getattr(ss, k), want[k],
                                          err_msg=f"mode {d} {k}")
        out_r, st = engine.mttkrp(st, tf)
        out_s, ss = stream_mttkrp(ss, tf)
        assert torch.equal(out_r, out_s), f"mode {d}"
    assert ss.mode == start_mode
    return ss


# --------------------------------------------------------------------------
# Bitwise parity: backends x schedules x nmodes x start modes.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("schedule", ["compact", "rect"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_bitwise_all_backends(backend, schedule, fuse):
    """Against the resident engine with and without the fused remap (rows
    6 and 4 of the kernel table; their plain versions sum in one
    order)."""
    idx, val, dims = _coo()
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8,
                     schedule=schedule)
    config = _cfg(backend=backend, rows_pp=8, chunk_nnz=40,
                  schedule=schedule, fuse_remap=fuse)
    ss = _assert_stream_matches_resident(config, t, _factors(dims))
    assert all(cs.nchunks > 1 for cs in ss.plan.chunks)


@pytest.mark.parametrize("nmodes,start_mode",
                         [(n, s) for n in (3, 4, 5) for s in range(n)])
@pytest.mark.parametrize("schedule", ["compact", "rect"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_bitwise_nmodes_start_modes(backend, schedule, nmodes,
                                           start_mode):
    idx, val, dims = _coo(nmodes=nmodes, nnz=250, seed=nmodes)
    t = build_flycoo(idx, val, dims, rows_pp=4, block_p=8,
                     schedule=schedule)
    config = _cfg(backend=backend, rows_pp=4, chunk_nnz=48,
                  schedule=schedule)
    _assert_stream_matches_resident(config, t, _factors(dims),
                                    start_mode=start_mode)


def test_stream_bitwise_six_modes():
    idx, val, dims = _coo(nmodes=6, nnz=250)
    t = build_flycoo(idx, val, dims, rows_pp=4, block_p=8)
    _assert_stream_matches_resident(
        _cfg(backend="cuda_fused", rows_pp=4, chunk_nnz=64), t,
        _factors(dims))


# --------------------------------------------------------------------------
# Chunk boundaries: every chunking is bitwise equal.
# --------------------------------------------------------------------------
def _boundary_case():
    idx, val, dims = _coo(nnz=500)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    smax = max(p.padded_nnz for p in t.plans)
    one_partition = max(p.padded_nnz // p.kappa for p in t.plans)
    return t, dims, smax, one_partition


@pytest.mark.parametrize("which", ["one_block", "one_partition", "smax",
                                   "smax+1", "137", "384"])
@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
def test_chunk_boundaries_bitwise_equal(backend, which):
    """One block (every chunk one partition), one partition's slots, a
    single chunk a mode (S and S+1), and sizes that divide nothing."""
    t, dims, smax, one_partition = _boundary_case()
    chunk_nnz = {"one_block": 1, "one_partition": one_partition,
                 "smax": smax, "smax+1": smax + 1, "137": 137,
                 "384": 384}[which]
    config = _cfg(backend=backend, rows_pp=8, chunk_nnz=chunk_nnz)
    ss = _assert_stream_matches_resident(config, t, _factors(dims))
    assert ss.stats.chunks_streamed == sum(
        cs.nchunks for cs in ss.plan.chunks)
    if which.startswith("smax"):
        assert all(cs.nchunks == 1 for cs in ss.plan.chunks)
    if which == "one_block":
        assert all(cs.nchunks == p.kappa
                   for cs, p in zip(ss.plan.chunks, t.plans))


@pytest.mark.parametrize("backend", BACKENDS)
def test_oversized_single_partition_chunks(backend):
    """A mode of two rows (``vast``'s mode 2) has two partitions, each
    larger than the target: each forms an oversized chunk of its own
    (``chunk_schedule``'s rule), and the mode still streams bitwise."""
    t = zipf_tensor((60, 50, 2), 3000, a=1.2, seed=5, rows_pp=1, block_p=8)
    config = _cfg(backend=backend, rows_pp=1, chunk_nnz=64)
    ss = _assert_stream_matches_resident(config, t, _factors(t.dims))
    cs = ss.plan.chunks[2]
    assert t.plans[2].kappa == cs.nchunks == 2
    assert all(ch.static.kappa == 1
               and ch.static.padded_nnz > ss.plan.target_slots
               for ch in ss.chunks[2])


# --------------------------------------------------------------------------
# Full ALS sweeps.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_cp_als_stream_equals_cp_als(backend):
    idx, val, dims = _coo(nnz=400)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    config = _cfg(backend=backend, rows_pp=8, chunk_nnz=64)
    init = _factors(dims, rank=4, seed=3)
    res = cp_als(t, rank=4, iters=3, config=config, factors=init)
    res_s = cp_als_stream(t, rank=4, iters=3, config=config, factors=init)
    assert res.fits == res_s.fits
    for a, b in zip(res.factors, res_s.factors):
        assert torch.equal(a, b)
    assert torch.equal(res.lam, res_s.lam)


def test_cp_als_stream_generator_and_refusals(tmp_path):
    idx, val, dims = _coo(nnz=300)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    config = _cfg(rows_pp=8, chunk_nnz=64)
    a = cp_als_stream(t, 3, iters=2, config=config,
                      generator=torch.Generator().manual_seed(4))
    b = cp_als(t, 3, iters=2, config=config,
               generator=torch.Generator().manual_seed(4))
    assert a.fits == b.fits and len(a.fits) == 2
    # the resilience arguments run (resilience is ported); with no fault
    # they change nothing
    for kw in (dict(ladder=True), dict(checkpoint=str(tmp_path)),
               dict(checkpoint=str(tmp_path), resume=True)):
        c = cp_als_stream(t, 3, iters=2, config=config,
                          generator=torch.Generator().manual_seed(4), **kw)
        assert c.fits == a.fits
    ss = stream_init(t, config)
    f = interop.factors_from_numpy(_factors(dims), device="cpu")
    out, _ = stream_mttkrp(ss, f, policy=DEFAULT_POLICY)
    want, _ = stream_mttkrp(stream_init(t, config), f)
    assert torch.equal(out, want)
    ss = stream_init(t, config)
    with pytest.raises(ValueError, match="without rotating"):
        stream_mttkrp(ss, interop.factors_from_numpy(_factors(dims),
                                                     device="cpu"), mode=1)
    with pytest.raises(ValueError, match="out of range"):
        stream_init(t, config, start_mode=3)


# --------------------------------------------------------------------------
# The kernels' schedule: work tables at the resident mode's cap.
# --------------------------------------------------------------------------
def _schedule_plain(monkeypatch):
    """Route the four EC wrappers the stream runs to the plain version of
    the work table they are given (``chunked_plain*``), as the kernels
    compute it."""
    def compact_gather(val, lrow, upos, bpart, uidx, nuniq, factors, *,
                       kappa, rows_pp, nblocks, block_p, pstart=None,
                       work=None):
        return kmt.chunked_plain(val, lrow, upos, bpart, uidx, nuniq,
                                 factors, kappa=kappa, rows_pp=rows_pp,
                                 nblocks=nblocks, block_p=block_p,
                                 work=work)

    def rect_gather(val, lrow, lidx, factors, *, kappa, rows_pp, blocks_pp,
                    block_p, pstart=None, work=None):
        return kmt.chunked_plain_gather(val, lrow, lidx, factors,
                                        kappa=kappa, rows_pp=rows_pp,
                                        block_p=block_p, work=work)

    def pregathered(gathered, val, lrow, *args, kappa, rows_pp, block_p,
                    pstart=None, work=None, **_):
        return kmt.chunked_plain_pregathered(gathered, val, lrow,
                                             kappa=kappa, rows_pp=rows_pp,
                                             block_p=block_p, work=work)

    monkeypatch.setattr(kmt, "mttkrp_fused_gather_compact", compact_gather)
    monkeypatch.setattr(kmt, "mttkrp_fused_gather", rect_gather)
    monkeypatch.setattr(kmt, "mttkrp_fused_compact", pregathered)
    monkeypatch.setattr(kmt, "mttkrp_fused", pregathered)


def _table_case(schedule):
    # > 264 blocks a mode, so the resident cap (default_cap) is above 1,
    # while a chunk of 100 blocks has a cap of 1 of its own
    t = zipf_tensor((300, 200, 100), 5000, a=1.2, seed=2, rows_pp=8,
                    block_p=4, schedule=schedule)
    assert all(engine.api.mode_cap(p) > 1 for p in t.plans)
    return t


@pytest.mark.parametrize("backend,schedule", [
    ("cuda_fused", "compact"), ("cuda_fused", "rect"), ("cuda", "compact"),
    ("cuda", "rect")])
def test_chunk_tables_at_resident_cap_are_bitwise(monkeypatch, backend,
                                                  schedule):
    """Each chunk's table at the resident mode's cap: the schedule's plain
    version streams bitwise the resident one, and some partition is
    split (so the cap matters)."""
    _schedule_plain(monkeypatch)
    t = _table_case(schedule)
    config = _cfg(backend=backend, rows_pp=8, block_p=4, chunk_nnz=400,
                  schedule=schedule, fuse_remap=False)
    ss = _assert_stream_matches_resident(config, t, _factors(t.dims))
    assert any(ch.work.n_partials for chs in ss.chunks for ch in chs)
    for chs in ss.chunks:
        for ch in chs:
            assert kmt.checked_for(ch.work) == (ch.static.kappa,
                                                ch.static.nblocks)


@pytest.mark.parametrize("backend,schedule", [
    ("cuda_fused", "compact"), ("cuda_fused", "rect"), ("cuda", "compact"),
    ("cuda", "rect")])
def test_chunk_tables_at_own_cap_break_bitwise(monkeypatch, backend,
                                               schedule):
    """The trap the resident cap avoids: a chunk's table at the chunk's
    own cap splits the hot partitions differently, so the partial sums
    are added in another order and the bitwise check fails."""
    _schedule_plain(monkeypatch)
    monkeypatch.setattr(stream, "mode_work",
                        lambda plan, cap: engine.api.mode_work(plan))
    t = _table_case(schedule)
    config = _cfg(backend=backend, rows_pp=8, block_p=4, chunk_nnz=400,
                  schedule=schedule, fuse_remap=False)
    with pytest.raises(AssertionError, match="mode"):
        _assert_stream_matches_resident(config, t, _factors(t.dims))


# --------------------------------------------------------------------------
# No host sync in the chunk loop.
# --------------------------------------------------------------------------
def test_stream_path_reads_nothing_back(monkeypatch):
    """The streamed rotation calls no ``.cpu()``, ``.item()``,
    ``.tolist()`` or ``synchronize``: counted by patching them."""
    idx, val, dims = _coo(nnz=400)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    tf = interop.factors_from_numpy(_factors(dims), device="cpu")
    calls = []

    def counting(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for b in BACKENDS:
        ss = stream_init(t, _cfg(backend=b, rows_pp=8, chunk_nnz=48))
        with monkeypatch.context() as m:
            for name in ("cpu", "item", "tolist"):
                m.setattr(torch.Tensor, name,
                          counting(name, getattr(torch.Tensor, name)))
            for owner in (torch.cuda, torch.cuda.Event, torch.cuda.Stream):
                m.setattr(owner, "synchronize",
                          counting("synchronize", owner.synchronize))
            outs, ss = stream_all_modes(ss, tf)
        assert calls == [], (b, calls)
        assert ss.stats.chunks_streamed > len(dims)


# --------------------------------------------------------------------------
# The budget model, the ring and auto residency.
# --------------------------------------------------------------------------
def test_budget_sizes_ring_under_budget():
    """An achievable budget bounds the ring; the tensor oversubscribes it
    yet streams bitwise; every upload but each mode's first is issued
    ahead."""
    idx, val, dims = _coo(nnz=600)
    t = build_flycoo(idx, val, dims, rows_pp=8)
    budget = 24 * 1024
    config = _cfg(backend="torch", rows_pp=8, rank_hint=5,
                  device_budget_bytes=budget)
    assert resident_bytes(t, config) > budget
    ss = _assert_stream_matches_resident(config, t, _factors(dims))
    assert 0 < ss.stats.peak_ring_bytes <= budget
    assert ss.stats.peak_ring_chunks <= config.stream_ring
    assert ss.stats.h2d_bytes > 0 and ss.stats.fragment_bytes > 0
    assert ss.stats.overlap_efficiency == pytest.approx(
        1 - t.nmodes / ss.stats.uploads)
    row = ss.stats.as_row()
    assert row["device_peak_bytes"] is None and row["host_remap_s"] >= 0
    model = stream_transfer_model(t, config)
    assert ss.stats.h2d_bytes <= model["h2d_bytes"]


@pytest.mark.parametrize("ring", [1, 2, 3])
def test_ring_depths(ring):
    idx, val, dims = _coo(nnz=400)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    config = _cfg(backend="cuda_fused", rows_pp=8, chunk_nnz=48,
                  stream_ring=ring)
    ss = _assert_stream_matches_resident(config, t, _factors(dims))
    assert len(ss.ring.slots) == ring
    assert ss.stats.peak_ring_chunks == ring
    # a ring of one has no slot to upload ahead into
    ahead = sum(cs.nchunks - 1 for cs in ss.plan.chunks) if ring > 1 else 0
    assert ss.stats.overlapped_uploads == ahead


def test_resolve_chunk_slots_priority():
    assert resolve_chunk_slots(_cfg(chunk_nnz=999), (64, 64, 64)) == 999
    assert resolve_chunk_slots(_cfg(), (64, 64, 64)) == \
        stream.DEFAULT_CHUNK_SLOTS
    tight = resolve_chunk_slots(
        _cfg(device_budget_bytes=1 << 20, rows_pp=8), (64, 64, 64))
    loose = resolve_chunk_slots(
        _cfg(device_budget_bytes=1 << 24, rows_pp=8), (64, 64, 64))
    assert tight < loose


@pytest.mark.parametrize("budget", [1 << 18, 1 << 20, 1 << 24])
@pytest.mark.parametrize("tables", [False, True])
def test_resolve_chunk_slots_equals_reference(budget, tables):
    """The derived sizing without plans (``kappa_for``) under matching
    knobs."""
    dims = (300, 64, 1000)
    got = resolve_chunk_slots(_cfg(device_budget_bytes=budget, rows_pp=8,
                                   min_partitions=1), dims, tables=tables)
    want = rstream.resolve_chunk_slots(
        RConfig(device_budget_bytes=budget, rows_pp=8), dims, tables=tables)
    assert got == want


def test_make_engine_auto_residency():
    idx, val, dims = _coo()
    big = make_engine((idx, val, dims),
                      PlanSpec(device="cpu", rows_pp=8,
                               device_budget_bytes=1 << 30), cache=False)
    assert isinstance(big, engine.EngineState)
    small = make_engine((idx, val, dims),
                        PlanSpec(device="cpu", rows_pp=8, rank_hint=5,
                                 device_budget_bytes=16_000), cache=False)
    assert isinstance(small, StreamState)
    forced = make_engine((idx, val, dims),
                         PlanSpec(device="cpu", rows_pp=8,
                                  residency="stream", chunk_nnz=256),
                         cache=False)
    assert isinstance(forced, StreamState)
    assert forced.plan.target_slots == 256
    full = make_engine((idx, val, dims),
                       PlanSpec(device="cpu", rows_pp=8, residency="full",
                                device_budget_bytes=16), cache=False)
    assert isinstance(full, engine.EngineState)


@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
def test_make_engine_resolves_like_reference(backend):
    """``auto`` against a budget just under and just over the reference's
    ``resident_bytes``, which the port's equals."""
    idx, val, dims = _coo(nnz=500)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    rt = rbuild(idx, val, dims, rows_pp=8, block_p=8)
    cfg = _cfg(backend=backend, rows_pp=8, block_p=8)
    need = resident_bytes(t, cfg)
    assert need == rstream.resident_bytes(
        rt, RConfig(backend=RBACKEND[backend], rows_pp=8, block_p=8))
    for budget, tier in ((need - 1, StreamState),
                         (need, engine.EngineState)):
        spec = PlanSpec(device="cpu", backend=backend, rows_pp=8,
                        block_p=8, device_budget_bytes=budget)
        assert isinstance(make_engine(t, spec, cache=False), tier)
        rspec = RPlanSpec(backend=RBACKEND[backend], rows_pp=8, block_p=8,
                          device_budget_bytes=budget)
        rtier = (rstream.StreamState if tier is StreamState
                 else rengine.EngineState)
        assert isinstance(rengine.make_engine(rt, rspec, cache=False), rtier)


def test_planspec_canonical():
    """``auto`` with no budget is ``full``; ``full`` drops the streaming
    knobs; the shared-memory budget is never derived from the device
    budget (the reference derives its VMEM budget)."""
    assert PlanSpec(device="cpu").canonical().residency == "full"
    spec = PlanSpec(device="cpu", residency="full", chunk_nnz=64,
                    stream_ring=3).canonical()
    assert (spec.chunk_nnz, spec.stream_ring) == (None, 2)
    spec = PlanSpec(device="cpu", device_budget_bytes=1 << 23).canonical()
    assert spec.residency == "auto"
    assert spec.smem_budget_bytes == kmt.SMEM_PER_BLOCK
    rs = RPlanSpec(device_budget_bytes=1 << 23).canonical()
    assert rs.vmem_budget_bytes is not None
    spec = PlanSpec(device="cpu", residency="stream", chunk_nnz=64,
                    stream_ring=3).canonical()
    cfg = spec.to_config()
    assert (cfg.residency, cfg.chunk_nnz, cfg.stream_ring) == \
        ("stream", 64, 3)
    for bad in (dict(residency="disk"), dict(chunk_nnz=0),
                dict(device_budget_bytes=0), dict(stream_ring=0)):
        with pytest.raises(ValueError):
            _cfg(**bad)


# --------------------------------------------------------------------------
# The autotuner prices streaming as the reference does.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend,schedule,dedup,residency,budget", [
    ("torch", "compact", True, "stream", None),
    ("torch", "rect", True, "stream", None),
    ("cuda", "compact", True, "stream", None),
    ("cuda_fused", "compact", True, "stream", None),
    ("cuda_fused", "compact", False, "stream", None),
    ("cuda_fused", "rect", True, "stream", None),
    ("cuda_fused", "compact", True, "auto", 20_000),
    ("cuda_fused", "compact", True, "auto", 1 << 30),
    ("torch", "compact", True, "stream", 60_000),
    ("cuda_fused", "compact", True, "stream", 60_000)])
def test_stream_costs_equal_reference(backend, schedule, dedup, residency,
                                      budget):
    idx, val, dims = _coo(nnz=500)
    knobs = dict(schedule=schedule, block_p=16, rows_pp=8, dedup=dedup,
                 residency=residency, device_budget_bytes=budget)
    rspec = RPlanSpec(backend=RBACKEND[backend], **knobs)
    spec = PlanSpec(device="cpu", backend=backend, min_partitions=1,
                    **knobs)
    degrees = _mode_degrees(idx, dims)
    got = analytic_cost(degrees, dims, len(idx), spec)
    assert got == ranalytic(degrees, dims, len(idx), rspec)
    t = engine.api.as_flycoo((idx, val, dims), spec.to_config())
    rt = rbuild(idx, val, dims, rows_pp=8, block_p=16, schedule=schedule)
    assert modeled_cost(t, spec) == rmodeled(rt, rspec)
    full = dataclasses.replace(spec, residency="full")
    if residency == "stream":
        assert modeled_cost(t, spec) > modeled_cost(t, full)
        assert got > analytic_cost(degrees, dims, len(idx), full)


# --------------------------------------------------------------------------
# Against the reference's stream.
# --------------------------------------------------------------------------
def _rcs_equal(cs, rcs):
    assert np.array_equal(cs.part_start, rcs.part_start)
    assert np.array_equal(cs.block_start, rcs.block_start)
    assert (cs.chunk_kappa, cs.chunk_blocks, cs.block_p) == \
        (rcs.chunk_kappa, rcs.chunk_blocks, rcs.block_p)


@pytest.mark.parametrize("schedule", ["compact", "rect"])
@pytest.mark.parametrize("knob", ["chunk_nnz", "budget", "default"])
def test_plans_and_models_equal_reference(knob, schedule):
    idx, val, dims = _coo(nmodes=4, nnz=700, seed=3)
    kw = dict(rows_pp=4, block_p=8, schedule=schedule)
    t = build_flycoo(idx, val, dims, **kw)
    rt = rbuild(idx, val, dims, **kw)
    extra = {"chunk_nnz": dict(chunk_nnz=100),
             "budget": dict(device_budget_bytes=40_000, rank_hint=6),
             "default": {}}[knob]
    for backend in ("cuda_fused", "torch"):
        cfg = _cfg(backend=backend, kappa_policy="fixed", kappa=5, **extra,
                   **{k: v for k, v in kw.items() if k != "rows_pp"})
        rcfg = RConfig(backend=RBACKEND[backend], kappa_policy="fixed",
                       kappa=5, **extra,
                       **{k: v for k, v in kw.items() if k != "rows_pp"})
        plan, rplan = plan_stream(t, cfg), rstream.plan_stream(rt, rcfg)
        assert plan.target_slots == rplan.target_slots
        assert plan.tables == rplan.tables
        assert plan.lstatics == tuple(tuple(s) for s in rplan.lstatics)
        for d, (cs, rcs) in enumerate(zip(plan.chunks, rplan.chunks)):
            _rcs_equal(cs, rcs)
            _rcs_equal(chunk_schedule(t.plans[d], 100),
                       rstream.chunk_schedule(rt.plans[d], 100))
            for c in range(cs.nchunks):
                assert np.array_equal(
                    chunk_bpart(t.plans[d], cs, c),
                    rstream.chunk_bpart(rt.plans[d], rcs, c))
        assert resident_bytes(t, cfg) == rstream.resident_bytes(rt, rcfg)
        assert stream_transfer_model(t, cfg) == \
            rstream.stream_transfer_model(rt, rcfg)
        assert stream._stream_plan_key(t, cfg) == \
            rstream._stream_plan_key(rt, rcfg)


@pytest.mark.parametrize("backend,schedule,nmodes,start", [
    ("torch", "compact", 3, 0), ("torch", "rect", 4, 2),
    ("ref", "compact", 5, 4), ("cuda", "compact", 3, 1),
    ("cuda_fused", "compact", 3, 0), ("cuda_fused", "rect", 3, 2),
    ("cuda_fused", "compact", 4, 1)])
def test_stream_matches_reference_stream(backend, schedule, nmodes, start):
    """The same rotation through both packages' streams: every output
    within the tolerance, the host layout after every mode exactly the
    reference's, the same counts."""
    idx, val, dims = _coo(nmodes=nmodes, nnz=220, seed=nmodes)
    kw = dict(rows_pp=4, block_p=8, schedule=schedule)
    facs = _factors(dims, rank=6, seed=nmodes)
    cfg = _cfg(backend=backend, rows_pp=4, block_p=8, chunk_nnz=40,
               schedule=schedule)
    rcfg = RConfig(backend=RBACKEND[backend], rows_pp=4, block_p=8,
                   chunk_nnz=40, schedule=schedule, interpret=True)
    ss = stream_init(build_flycoo(idx, val, dims, **kw), cfg,
                     start_mode=start)
    rs = rstream.stream_init(rbuild(idx, val, dims, **kw), rcfg,
                             start_mode=start)
    tf = interop.factors_from_numpy(facs, device="cpu")
    rf = tuple(jnp.asarray(f) for f in facs)
    for _ in range(nmodes):
        for k in LAYOUT:
            a, b = getattr(ss, k), getattr(rs, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        d = ss.mode
        out, ss = stream_mttkrp(ss, tf)
        rout, rs = rstream.stream_mttkrp(rs, rf)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL,
                                   err_msg=f"mode {d}")
    for k in ("h2d_bytes", "fragment_bytes", "chunks_streamed", "uploads",
              "overlapped_uploads", "modes_streamed", "peak_ring_chunks"):
        if k == "h2d_bytes":
            assert getattr(ss.stats, k) <= getattr(rs.stats, k)
        else:
            assert getattr(ss.stats, k) == getattr(rs.stats, k), k


def test_cp_als_stream_matches_reference():
    """The reference's ``cp_als_stream`` and the port's from the
    reference's ``jax.random`` initial factors: fits and factors within
    the tolerance."""
    import jax

    from repro.core.cpd import init_factors as rinit

    idx, val, dims = _coo(nnz=400)
    kw = dict(rows_pp=8, block_p=8)
    key = jax.random.PRNGKey(3)
    init = [np.asarray(f) for f in rinit(key, dims, 4)]
    res = cp_als_stream(build_flycoo(idx, val, dims, **kw), 4, iters=3,
                        config=_cfg(rows_pp=8, chunk_nnz=64), factors=init)
    ref = rstream.cp_als_stream(rbuild(idx, val, dims, **kw), 4, iters=3,
                                key=key,
                                config=RConfig(rows_pp=8, chunk_nnz=64))
    np.testing.assert_allclose(res.fits, np.asarray(ref.fits), atol=1e-5)
    for a, b in zip(res.factors, ref.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# --------------------------------------------------------------------------
# The plan cache's stream tier and the disk tier.
# --------------------------------------------------------------------------
def test_stream_plan_cache_hits():
    idx, val, dims = _coo(nnz=400)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    cache = PlanCache()
    cfg = _cfg(rows_pp=8, chunk_nnz=64)
    a = stream_init(t, cfg, cache=cache)
    b = stream_init(t, cfg, cache=cache)
    assert a.plan is b.plan
    assert (cache.stream_misses, cache.stream_hits) == (1, 1)
    stream_init(t, dataclasses.replace(cfg, chunk_nnz=128), cache=cache)
    assert (cache.stream_misses, cache.stream_hits) == (2, 1)
    assert cache.stats()["stream_hits"] == 1
    from repro_torch.obs.metrics import REGISTRY

    assert REGISTRY.counter("stream_replan_outcomes")["hit"] >= 1
    cache.clear()
    stream_init(t, cfg, cache=cache)
    assert cache.stream_misses == 3
    cold = stream_init(t, cfg, cache=False).plan
    assert cold.target_slots == a.plan.target_slots
    for cs, ws in zip(cold.chunks, a.plan.chunks):
        _rcs_equal(cs, ws)


def test_plancache_disk_streamed_engine_parity(tmp_path):
    """A streamed engine built through a disk-persisted cache is bitwise
    the one built cold; a fresh cache loads the blob."""
    idx, val, dims = _coo(nnz=400)
    tf = interop.factors_from_numpy(_factors(dims), device="cpu")
    spec = PlanSpec(device="cpu", backend="cuda_fused", rows_pp=8,
                    residency="stream", chunk_nnz=64)
    outs_cold, _ = stream_all_modes(
        make_engine((idx, val, dims), spec, cache=False), tf)
    engine.api.as_flycoo((idx, val, dims), spec.to_config(),
                         cache=PlanCache(path=tmp_path))
    warm = PlanCache(path=tmp_path)
    outs_disk, _ = stream_all_modes(
        make_engine((idx, val, dims), spec, cache=warm), tf)
    assert warm.disk_loads == 1
    for a, b in zip(outs_cold, outs_disk):
        assert torch.equal(a, b)
