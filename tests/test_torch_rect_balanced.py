"""The pre-gathered and rect spMTTKRP kernels' work tables on the CPU.

``csrc/mttkrp_pregathered.cu`` (the ``cuda`` backend, both schedules) and
``csrc/mttkrp_gather.cu`` (rect ``cuda_fused``) walk the same work table
as the balanced kernels: chunks of at most ``cap`` blocks of one
partition, one CTA each, a split partition's partial tiles summed in
chunk order. Under rect the table lists only each partition's alive
extent (``kernels.mttkrp.rect_work``). The CUDA kernels run only on a
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``); what they take and
what they must compute is checked here: ``split_ranges`` and the rect
table, the plain versions of the schedule (``chunked_plain_pregathered``,
``chunked_plain_gather``) against the reference Pallas kernels
(``repro.kernels.ops.*(interpret=True)``) with tables that split every
partition, the engine's tables and the backends' use of them, and the
wrappers' refusal of a table that ``check_work`` never passed.

Tolerance for ``out_rel``: rtol = atol = 1e-4, as the reference's own
kernel tests (float32 sums of at most a few hundred products, here also
regrouped by chunk); MTTKRP outputs of a rotation rtol = atol = 2e-4, as
``tests/test_torch_engine.py``. The remap outputs are copies: bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as rengine
from repro.core import build_flycoo as rbuild
from repro.engine import ExecutionConfig as RConfig
from repro.kernels import ops
from repro_torch import engine
from repro_torch.core import build_flycoo, random_tensor, zipf_tensor
from repro_torch.engine import ExecutionConfig
from repro_torch.engine.api import mode_layout, mode_work
from repro_torch.engine.backends import fused_lidx, pregather
from repro_torch.kernels import mttkrp as kmt
from test_kernels import _compact_case, _gather_case
from test_torch_balanced import _meta_args, _pstarts
from test_torch_engine import _case, _same_layout
from test_torch_kernels import CASES, RECT, _remap_inputs, _t

TOL = dict(rtol=1e-4, atol=1e-4)
ROT_TOL = dict(rtol=2e-4, atol=2e-4)


def _rect(name):
    kw = {"zipf-hot": dict(dims=(400, 300, 200), nnz=30000, a=2.0, seed=4,
                           rows_pp=16, block_p=32),
          "zipf4": dict(dims=(300, 200, 100, 50), nnz=20000, a=1.6, seed=9,
                        rows_pp=8, block_p=16)}
    if name == "uniform-empty":
        return random_tensor((64, 50, 40, 30, 20), 40, seed=5, rows_pp=2,
                             block_p=32, schedule="rect")
    return zipf_tensor(**kw[name], schedule="rect")


RECT_TENSORS = {n: _rect(n) for n in ("zipf-hot", "zipf4", "uniform-empty")}
COMPACT = {"zipf-hot": zipf_tensor((400, 300, 200), 30000, a=2.0, seed=4,
                                   rows_pp=16, block_p=32)}


# --------------------------------------------------------------------------
# split_ranges and the rect table.
# --------------------------------------------------------------------------
def _split_loop(pstart, cap):
    """The whole-run split, one partition at a time: ``ceil(n / cap)``
    chunks (one for an empty partition), the first ``n % k`` one block
    longer."""
    rows = []
    for j in range(len(pstart) - 1):
        lo, n = int(pstart[j]), int(pstart[j + 1] - pstart[j])
        k = max(1, -(-n // cap))
        for i in range(k):
            size = n // k + (i < n % k)
            rows.append((j, lo, lo + size))
            lo += size
    return np.array(rows, dtype=np.int64)


@pytest.mark.parametrize("name", ["zipf-hot", "uniform-empty"])
@pytest.mark.parametrize("cap", [1, 3, None, 10**6])
def test_split_partitions_is_the_whole_run_split(name, cap):
    """``split_partitions(pstart, cap)``, now ``split_ranges`` over
    ``[pstart[j], pstart[j+1])``, gives exactly the whole-run split on
    compact and rect plans."""
    t = RECT_TENSORS[name]
    comp = COMPACT.get(name) or random_tensor(
        (64, 50, 40, 30, 20), 40, seed=5, rows_pp=2, block_p=32)
    for ps in _pstarts(t) + _pstarts(comp):
        c = kmt.default_cap(int(ps[-1])) if cap is None else cap
        got = kmt.split_partitions(ps, c)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, _split_loop(ps, c))
        np.testing.assert_array_equal(
            got, kmt.split_ranges(ps[:-1], ps[1:], c))


def test_split_ranges_cuts_each_range():
    """Ranges that do not tile the blocks: each is cut into chunks of at
    most ``cap`` near-equal blocks, an empty one kept as one empty chunk
    at its begin; a range that ends before its begin is refused."""
    begin = np.array([0, 10, 10, 40, 57])
    end = np.array([7, 10, 31, 41, 57])
    got = kmt.split_ranges(begin, end, 4)
    for j, (b, e) in enumerate(zip(begin, end)):
        rows = got[got[:, 0] == j]
        assert rows[0, 1] == b and rows[-1, 2] == e
        assert (rows[1:, 1] == rows[:-1, 2]).all()
        sizes = rows[:, 2] - rows[:, 1]
        assert (sizes <= 4).all() and sizes.max() - sizes.min() <= 1
        assert len(rows) == max(1, -(-(e - b) // 4))
    with pytest.raises(ValueError, match="end at or after"):
        kmt.split_ranges(np.array([3]), np.array([2]), 4)
    with pytest.raises(ValueError, match="cap"):
        kmt.split_ranges(begin, end, 0)


def _extents(plan):
    alive = -(-plan.part_nnz // plan.block_p)
    begin = np.arange(plan.kappa) * plan.blocks_pp
    return begin, begin + alive


@pytest.mark.parametrize("name", sorted(RECT_TENSORS))
def test_rect_table_lists_only_the_alive_extents(name):
    """Every mode of a rect plan: the table lists each partition's alive
    extent exactly once and no pad block, covers every alive slot, cuts
    chunks at ``default_cap`` of the alive blocks (not of all blocks),
    keeps one empty chunk for an empty partition, and is sealed for the
    plan."""
    t = RECT_TENSORS[name]
    for plan in t.plans:
        work = kmt.rect_work(plan.part_nnz, plan.blocks_pp, plan.block_p,
                             plan.slot_of_elem)
        begin, end = _extents(plan)
        cap = kmt.default_cap(int((end - begin).sum()))
        ps = np.arange(plan.kappa + 1) * plan.blocks_pp
        c = work.chunks.numpy().astype(np.int64)
        listed = np.zeros(plan.nblocks, dtype=np.int64)
        for lo, hi in c[:, 1:3]:
            listed[lo:hi] += 1
        want = np.zeros(plan.nblocks, dtype=np.int64)
        for lo, hi in zip(begin, end):
            want[lo:hi] = 1
        np.testing.assert_array_equal(listed, want)
        assert listed[plan.slot_of_elem // plan.block_p].all()
        assert (c[:, 2] - c[:, 1] <= cap).all()
        assert cap <= kmt.default_cap(plan.nblocks)
        kmt.check_work(work, ps)
        assert kmt.checked_for(work) == (plan.kappa, plan.nblocks)
        for j in np.flatnonzero(plan.part_nnz == 0):
            assert c[c[:, 0] == j, 1:3].tolist() == [[ps[j], ps[j]]]
        np.testing.assert_array_equal(
            c[np.lexsort((c[:, 1], c[:, 0]))][:, :3],
            kmt.split_ranges(begin, end, cap))
    if name == "uniform-empty":
        assert any((p.part_nnz == 0).any() for p in t.plans)


def test_rect_table_splits_the_hot_partition():
    """At nell1-like skew the hot partition is the one walked longest;
    the rect table cuts it into chunks of at most the cap, where a CTA a
    partition would walk all of it. The cap counts alive blocks only: of
    all ``kappa * blocks_pp`` blocks it would be larger."""
    plan = RECT_TENSORS["zipf-hot"].plans[0]
    work = kmt.rect_work(plan.part_nnz, plan.blocks_pp, plan.block_p,
                         plan.slot_of_elem)
    alive = int((-(-plan.part_nnz // plan.block_p)).sum())
    assert kmt.default_cap(alive) < kmt.default_cap(plan.nblocks)
    hot = int(plan.part_nnz.argmax())
    c = work.chunks.numpy()
    rows = c[c[:, 0] == hot]
    assert len(rows) >= 2 and (rows[:, 3] >= 0).all()
    assert (work.wsum.numpy()[:, 0] == hot).sum() == 1
    assert (c[:, 2] - c[:, 1]).max() < -(-plan.part_nnz.max()
                                         // plan.block_p)


def test_rect_work_refuses_a_slot_past_its_extent():
    """The alive-first order is the plan's invariant, not a layout's: a
    layout whose alive slot lies past its partition's extent is refused
    where the table is built, as is a partition too long for
    ``blocks_pp``."""
    plan = RECT_TENSORS["zipf-hot"].plans[1]
    slots = plan.slot_of_elem.copy()
    j = int(np.flatnonzero(plan.part_nnz < (plan.blocks_pp - 1)
                           * plan.block_p)[0])
    slots[np.flatnonzero(slots // (plan.blocks_pp * plan.block_p) == j)[0]] \
        = (j + 1) * plan.blocks_pp * plan.block_p - 1
    with pytest.raises(ValueError, match="no chunk lists"):
        kmt.rect_work(plan.part_nnz, plan.blocks_pp, plan.block_p, slots)
    with pytest.raises(ValueError, match="does not fit"):
        kmt.rect_work(plan.part_nnz, plan.blocks_pp - 1, plan.block_p,
                      plan.slot_of_elem)


# --------------------------------------------------------------------------
# The plain versions of the schedule against the Pallas kernels.
# --------------------------------------------------------------------------
def _rect_ps(kappa, blocks_pp):
    return np.arange(kappa + 1) * blocks_pp


@pytest.mark.parametrize("kappa,rows_pp,blocks_pp,p", RECT)
@pytest.mark.parametrize("cap", [1, 2])
def test_chunked_plain_pregathered_matches_pallas_rect(kappa, rows_pp,
                                                       blocks_pp, p, cap):
    """Rect EC over a pre-gathered operand on split full-range tables
    against ``ops.mttkrp_fused`` (the reference test's inputs: pads
    anywhere, so every block is listed)."""
    rng = np.random.default_rng(kappa * 31 + cap)
    s, nm1, r = kappa * blocks_pp * p, 3, 16
    g = rng.standard_normal((s, nm1, r)).astype(np.float32)
    val = rng.standard_normal(s).astype(np.float32)
    lrow = rng.integers(-1, rows_pp, s).astype(np.int32)
    val[lrow < 0] = 0.0
    kw = dict(kappa=kappa, rows_pp=rows_pp, block_p=p)
    want = ops.mttkrp_fused(g, val, lrow, blocks_pp=blocks_pp,
                            interpret=True, **kw)
    work = kmt.work_chunks(_rect_ps(kappa, blocks_pp), cap)
    assert (work.n_partials > 0) == (blocks_pp > cap)
    got = kmt.chunked_plain_pregathered(_t(g), _t(val), _t(lrow), **kw,
                                        work=work)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,fac", CASES)
@pytest.mark.parametrize("cap", [1, 2])
def test_chunked_plain_pregathered_matches_pallas_compact(shape, fac, cap):
    """The same on the compact schedule against
    ``ops.mttkrp_fused_compact``."""
    (kappa, part_blocks, p), (nm1, r) = shape, fac
    c = _compact_case(kappa * 17 + p, kappa, part_blocks, p, nm1, r)
    kw = dict(kappa=c["kappa"], rows_pp=c["rows_pp"], block_p=c["p"])
    want = ops.mttkrp_fused_compact(c["gathered"], c["val"], c["lrow"],
                                    c["bpart"], nblocks=c["nblocks"],
                                    interpret=True, **kw)
    work = kmt.work_chunks(np.concatenate([[0], np.cumsum(part_blocks)]),
                           cap)
    got = kmt.chunked_plain_pregathered(_t(c["gathered"]), _t(c["val"]),
                                        _t(c["lrow"]), **kw, work=work)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kappa,rows_pp,blocks_pp,p", RECT[:3])
@pytest.mark.parametrize("nm1,r", [(2, 8), (3, 32)])
@pytest.mark.parametrize("cap", [1, 2])
def test_chunked_plain_gather_matches_pallas(kappa, rows_pp, blocks_pp, p,
                                             nm1, r, cap):
    """Rect EC through ``lidx`` on split full-range tables against
    ``ops.mttkrp_fused_gather``."""
    facs, lidx, val, lrow, _ = _gather_case(kappa * 100 + nm1 + cap, kappa,
                                            rows_pp, blocks_pp, p, nm1, r)
    kw = dict(kappa=kappa, rows_pp=rows_pp, block_p=p)
    want = ops.mttkrp_fused_gather(val, lrow, lidx, facs,
                                   blocks_pp=blocks_pp, interpret=True, **kw)
    got = kmt.chunked_plain_gather(
        _t(val), _t(lrow), _t(lidx, np.int32), tuple(_t(f) for f in facs),
        **kw, work=kmt.work_chunks(_rect_ps(kappa, blocks_pp), cap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kappa,rows_pp,blocks_pp,p,nm1,r", [
    (2, 8, 1, 8, 2, 8), (3, 4, 2, 16, 3, 32), (4, 16, 3, 16, 2, 8)])
@pytest.mark.parametrize("cap", [1, 2])
def test_chunked_plain_gather_remap_matches_pallas(kappa, rows_pp, blocks_pp,
                                                   p, nm1, r, cap):
    """The same with the remap against ``ops.mttkrp_fused_remap``:
    ``out_rel`` within the tolerance, the next layout bitwise."""
    facs, lidx, val, lrow, _ = _gather_case(7 * kappa + p + cap, kappa,
                                            rows_pp, blocks_pp, p, nm1, r)
    idx, alpha, smax = _remap_inputs(
        {"nblocks": kappa * blocks_pp, "p": p, "nm1": nm1, "lrow": lrow},
        p + nm1)
    kw = dict(kappa=kappa, rows_pp=rows_pp, block_p=p)
    want = ops.mttkrp_fused_remap(val, idx, alpha, lrow, lidx, facs,
                                  blocks_pp=blocks_pp, smax=smax,
                                  next_mode=1, interpret=True, **kw)
    got = kmt.chunked_plain_gather(
        _t(val), _t(lrow), _t(lidx, np.int32), tuple(_t(f) for f in facs),
        **kw, work=kmt.work_chunks(_rect_ps(kappa, blocks_pp), cap),
        remap=(_t(idx), _t(alpha), smax, 1))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _engine_mode(t, backend, d, rank=16):
    state = engine.init(t, ExecutionConfig(backend=backend, device="cpu"),
                        start_mode=d)
    rng = np.random.default_rng(d + 11)
    facs = [torch.from_numpy(rng.standard_normal((n, rank))
                             .astype(np.float32)) for n in t.dims]
    L = mode_layout(state, (state.val, state.idx, state.alpha), d)
    return state, L, facs, state.statics[d]


@pytest.mark.parametrize("name,d", [("zipf-hot", 0), ("zipf-hot", 2),
                                    ("zipf4", 1), ("uniform-empty", 3)])
def test_alive_extent_table_gives_the_plain_result(name, d):
    """On the engine's rect layouts the state's table, which skips every
    pad block, gives the plain versions' ``out_rel`` (gather and
    pre-gathered) and, with the remap, bitwise the plain next layout."""
    t = RECT_TENSORS[name]
    state, L, facs, plan = _engine_mode(t, "cuda_fused", d)
    work = kmt.WorkTable(L["work"], L["wsum"])
    listed = int((work.chunks[:, 2] - work.chunks[:, 1]).sum())
    assert listed < plan.nblocks or plan.blocks_pp == 1
    inputs = tuple(f for w, f in enumerate(facs) if w != d)
    lidx = fused_lidx(L["idx"], d)
    nxt = (d + 1) % t.nmodes
    rect = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                blocks_pp=plan.blocks_pp, block_p=plan.block_p)
    sched = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                 block_p=plan.block_p, work=work)
    want = kmt.mttkrp_fused_remap_plain(L["val"], L["idx"], L["alpha"],
                                        L["lrow"], lidx, inputs,
                                        smax=state.smax, next_mode=nxt,
                                        **rect)
    got = kmt.chunked_plain_gather(L["val"], L["lrow"], lidx, inputs,
                                   **sched, remap=(L["idx"], L["alpha"],
                                                   state.smax, nxt))
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    pre = kmt.chunked_plain_pregathered(pregather(L["idx"], facs, d),
                                        L["val"], L["lrow"], **sched)
    torch.testing.assert_close(pre, want[0], **TOL)


@pytest.mark.parametrize("mutant", ["drop", "repeat"])
@pytest.mark.parametrize("kernel", ["gather", "pregathered"])
def test_mutant_rect_tables_fail_the_tolerance(mutant, kernel):
    """A rect table that drops one of the hot partition's chunks, or lists
    one twice, changes that partition's rows beyond the tolerance and no
    other partition's."""
    t = RECT_TENSORS["zipf-hot"]
    state, L, facs, plan = _engine_mode(t, "cuda_fused", 0)
    hot = int(plan_part(t, 0).argmax())
    c = L["work"].numpy()[:, :3].astype(np.int64)
    chunks = c[np.lexsort((c[:, 1], c[:, 0]))]
    row = np.flatnonzero(chunks[:, 0] == hot)[1]
    chunks = (np.delete(chunks, row, 0) if mutant == "drop"
              else np.insert(chunks, row, chunks[row], 0))
    work = kmt.work_from_chunks(chunks, L["pstart"].numpy())
    inputs = tuple(f for w, f in enumerate(facs) if w != 0)
    sched = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                 block_p=plan.block_p, work=work)
    rect = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                blocks_pp=plan.blocks_pp, block_p=plan.block_p)
    if kernel == "gather":
        lidx = fused_lidx(L["idx"], 0)
        got = kmt.chunked_plain_gather(L["val"], L["lrow"], lidx, inputs,
                                       **sched)
        want = kmt.mttkrp_fused_gather_plain(L["val"], L["lrow"], lidx,
                                             inputs, **rect)
    else:
        g = pregather(L["idx"], facs, 0)
        got = kmt.chunked_plain_pregathered(g, L["val"], L["lrow"], **sched)
        want = kmt.mttkrp_fused_plain(g, L["val"], L["lrow"], **rect)
    rows = slice(hot * plan.rows_pp, (hot + 1) * plan.rows_pp)
    assert not torch.allclose(got[rows], want[rows], **TOL)
    keep = torch.ones(got.shape[0], dtype=torch.bool)
    keep[rows] = False
    torch.testing.assert_close(got[keep], want[keep], **TOL)


def plan_part(t, d):
    return t.plans[d].part_nnz


# --------------------------------------------------------------------------
# The engine's tables and the backends.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend,schedule", [
    ("cuda", "rect"), ("cuda_fused", "rect"), ("torch", "rect"),
    ("cuda", "compact")])
def test_engine_init_builds_the_rect_and_cuda_tables(backend, schedule):
    """``engine.init`` keeps each mode's table for the backends whose
    kernels take one (``cuda`` on both schedules, ``cuda_fused`` under
    rect): ``mode_work`` of the plan, sealed, the same one for both
    kernel backends; ``torch`` keeps none."""
    t = RECT_TENSORS["zipf-hot"] if schedule == "rect" \
        else COMPACT["zipf-hot"]
    state = engine.init(t, ExecutionConfig(backend=backend, device="cpu"))
    for p, s in zip(t.plans, state.sched):
        if backend == "torch":
            assert s.work is None and s.wsum is None
            continue
        want = mode_work(p)
        assert torch.equal(s.work, want.chunks)
        assert torch.equal(s.wsum, want.wsum)
        work = kmt.WorkTable(s.work, s.wsum)
        assert kmt.checked_for(work) == (p.kappa, p.nblocks)
        if schedule == "compact":
            assert torch.equal(s.work, kmt.work_chunks(
                s.pstart.numpy(), kmt.default_cap(p.nblocks)).chunks)
        else:
            assert torch.equal(s.work, kmt.rect_work(
                p.part_nnz, p.blocks_pp, p.block_p, p.slot_of_elem).chunks)
        if schedule == "compact" and backend == "cuda":
            assert s.upos is None


@pytest.mark.parametrize("backend,schedule,fuse,names", [
    ("cuda", "compact", True, ("mttkrp_fused_compact",)),
    ("cuda", "rect", True, ("mttkrp_fused",)),
    ("cuda_fused", "rect", True, ("mttkrp_fused_remap",)),
    ("cuda_fused", "rect", False, ("mttkrp_fused_gather",))])
def test_backends_pass_the_state_table(monkeypatch, backend, schedule, fuse,
                                       names):
    """``cuda`` and rect ``cuda_fused`` hand each mode's table from the
    layout to their wrappers (on the CPU the wrappers then ignore it)."""
    seen = []
    for name in names:
        real = getattr(kmt, name)

        def spy(*a, _real=real, **k):
            seen.append(k["work"])
            return _real(*a, **k)

        monkeypatch.setattr(kmt, name, spy)
    t = RECT_TENSORS["zipf4"] if schedule == "rect" else zipf_tensor(
        (300, 200, 100, 50), 20000, a=1.6, seed=9, rows_pp=8, block_p=16)
    rng = np.random.default_rng(0)
    facs = [torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
            for n in t.dims]
    state = engine.init(t, ExecutionConfig(backend=backend, device="cpu",
                                           fuse_remap=fuse))
    engine.all_modes(state, facs)
    assert len(seen) == t.nmodes
    for d, w in enumerate(seen):
        assert isinstance(w, kmt.WorkTable)
        assert w.chunks is state.sched[d].work
        assert w.wsum is state.sched[d].wsum


@pytest.mark.parametrize("backend,schedule,fuse", [
    ("cuda", "compact", True), ("cuda", "rect", True),
    ("cuda_fused", "rect", True), ("cuda_fused", "rect", False)])
def test_port_init_rotation_matches_reference_pallas(backend, schedule,
                                                     fuse):
    """The port's own ``engine.init`` (with its tables) rotating ``cuda``
    (both schedules) and rect ``cuda_fused`` against the reference's
    ``pallas`` / ``pallas_fused`` on the same COO data: every mode's
    output within the tolerance, the layouts bitwise equal."""
    idx, val, dims, facs, kw = _case(4, nnz=260, seed=6, schedule=schedule,
                                     block_p=16)
    ref_backend = {"cuda": "pallas", "cuda_fused": "pallas_fused"}[backend]
    r0 = rengine.init(rbuild(idx, val, dims, **kw),
                      RConfig(backend=ref_backend, interpret=True,
                              fuse_remap=fuse), start_mode=1)
    t0 = engine.init(build_flycoo(idx, val, dims, **kw),
                     ExecutionConfig(backend=backend, device="cpu",
                                     fuse_remap=fuse), start_mode=1)
    assert all(s.work is not None for s in t0.sched)
    routs, r1 = rengine.all_modes(r0, tuple(jnp.asarray(f) for f in facs))
    touts, t1 = engine.all_modes(t0, [torch.from_numpy(f) for f in facs])
    for d in range(4):
        np.testing.assert_allclose(touts[d].numpy(), np.asarray(routs[d]),
                                   **ROT_TOL)
    _same_layout(t0, r0)
    _same_layout(t1, r1)


# --------------------------------------------------------------------------
# Only a checked table reaches a kernel.
# --------------------------------------------------------------------------
# Hand-built tables for the 2-partition, 2-block plan of ``_meta_args``,
# each with one fault that check_work refuses, in a well-formed shape.
UNCHECKED = {
    "partition out of range": ((0, 0, 1, -1), (2, 1, 2, -1)),
    "blocks outside their partition": ((0, 0, 2, -1), (1, 1, 2, -1)),
    "partition missing": ((0, 0, 1, -1), (0, 1, 2, -1)),
}


def _meta_wrappers(rows_pp=4):
    """Every wrapper that takes ``work=``, on the meta tensors of
    ``_meta_args`` (rect: ``blocks_pp`` 1)."""
    args, kw = _meta_args(rows_pp=rows_pp)
    val, idx, alpha, lrow, upos, bpart, uidx, nuniq, facs = args
    comp = {k: kw[k] for k in ("kappa", "rows_pp", "nblocks", "block_p")}
    rect = dict(kappa=2, rows_pp=rows_pp, blocks_pp=1, block_p=8)
    remap = dict(smax=kw["smax"], next_mode=kw["next_mode"])
    lidx = torch.empty((2, 16), dtype=torch.int32, device="meta")
    g = torch.empty((16, 2, 32), device="meta")
    return {
        "mttkrp_fused": lambda w: kmt.mttkrp_fused(g, val, lrow, **rect,
                                                   work=w),
        "mttkrp_fused_compact": lambda w: kmt.mttkrp_fused_compact(
            g, val, lrow, bpart, **comp, work=w),
        "mttkrp_fused_gather": lambda w: kmt.mttkrp_fused_gather(
            val, lrow, lidx, facs, **rect, work=w),
        "mttkrp_fused_remap": lambda w: kmt.mttkrp_fused_remap(
            val, idx, alpha, lrow, lidx, facs, **rect, **remap, work=w),
        "mttkrp_fused_gather_compact": lambda w:
            kmt.mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx,
                                            nuniq, facs, **comp, work=w),
        "mttkrp_fused_remap_compact": lambda w:
            kmt.mttkrp_fused_remap_compact(*args, **kw, work=w),
    }


def _hand_table(chunks, device="meta"):
    return kmt.WorkTable(torch.tensor(chunks, dtype=torch.int32).to(device),
                         torch.zeros((0, 2), dtype=torch.int32).to(device))


@pytest.mark.parametrize("fault", sorted(UNCHECKED))
@pytest.mark.parametrize("name", sorted(_meta_wrappers()))
def test_wrappers_refuse_an_unchecked_table(fault, name):
    """A table that never passed ``check_work`` is refused by every
    wrapper before the device check (so meta tensors reach it), whatever
    its fault; ``work_from_chunks`` refuses to build the same table; the
    checked table passes on to the device check. Nothing launches."""
    before = dict(kmt.LAUNCHES)
    call = _meta_wrappers()[name]
    with pytest.raises(ValueError, match="only a table that check_work "
                                         "passed"):
        call(_hand_table(UNCHECKED[fault]))
    with pytest.raises(ValueError):
        kmt.work_from_chunks([c[:3] for c in UNCHECKED[fault]],
                             np.array([0, 1, 2]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(kmt.work_chunks(np.array([0, 1, 2]), 1).to("meta"))
    assert kmt.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(_meta_wrappers()))
def test_wrappers_refuse_a_changed_or_foreign_table(name):
    """A checked table edited in place, one built for another plan, a
    hand-built copy of a checked one, and one whose ``wsum`` was swapped
    are refused; a copy made by ``WorkTable.to`` is not."""
    call = _meta_wrappers()[name]
    good = kmt.work_chunks(np.array([0, 1, 2]), 1)
    edited = kmt.work_chunks(np.array([0, 1, 2]), 1)
    edited.chunks[0, 3] = -1
    other = kmt.work_chunks(np.array([0, 1, 3]), 1)   # nblocks 3
    copy = kmt.WorkTable(good.chunks.clone(), good.wsum)
    swapped = kmt.WorkTable(good.chunks, good.wsum.clone())
    for bad in (edited, other, copy, swapped):
        with pytest.raises(ValueError, match="only a table that "
                                             "check_work passed"):
            call(bad.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(good.to("meta"))
