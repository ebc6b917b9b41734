"""The balanced kernels' schedule (``csrc/mttkrp_balanced.cu``) on the CPU.

The CUDA kernels run only on a card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). What they take and what they must compute is
checked here: the work table that ``kernels.mttkrp.work_chunks`` builds
from a plan's block-start table, and ``chunked_plain``, the plain
version of the schedule, against the reference Pallas kernels
(``repro.kernels.ops.*(interpret=True)``) on the reference kernel tests'
inputs, with tables that split every partition.

Tolerance for ``out_rel``: rtol = atol = 1e-4, as the reference's own
kernel tests and ``tests/test_torch_kernels.py``: float32 sums of at
most a few hundred products, here also regrouped by chunk. The remap
outputs are copies: bitwise.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch import engine
from repro_torch.core import random_tensor, zipf_tensor
from repro_torch.engine import ExecutionConfig
from repro_torch.engine.api import mode_layout, mode_sched_arrays
from repro_torch.engine.config import SMEM_PER_BLOCK
from repro_torch.kernels import mttkrp as kmt
from test_kernels import _compact_case
from test_torch_kernels import CASES, _port_args, _remap_inputs, _t

TOL = dict(rtol=1e-4, atol=1e-4)


def _tensors():
    return {
        "zipf-hot": zipf_tensor((400, 300, 200), 30000, a=2.0, seed=4,
                                rows_pp=16, block_p=32),
        "zipf4": zipf_tensor((300, 200, 100, 50), 20000, a=1.6, seed=9,
                             rows_pp=8, block_p=16),
        "uniform": random_tensor((230, 170, 110), 7000, seed=3, rows_pp=16,
                                 block_p=16),
        "uniform-empty": random_tensor((64, 50, 40, 30, 20), 40, seed=5,
                                       rows_pp=2, block_p=32),
    }


TENSORS = _tensors()


def _pstarts(t):
    return [kmt.block_starts(torch.from_numpy(p.block_part), p.kappa).numpy()
            for p in t.plans]


def _check_table(work, ps, cap):
    """Every invariant of a work table built from ``ps`` at ``cap``."""
    c = work.chunks.numpy().astype(np.int64)
    w = work.wsum.numpy()
    part, b0, b1, pq = c.T
    nb = np.diff(ps)
    kappa, nblocks = nb.size, int(ps[-1])
    # every block exactly once; every chunk inside one partition, <= cap
    covered = np.zeros(nblocks, dtype=np.int64)
    for lo, hi in zip(b0, b1):
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert ((ps[part] <= b0) & (b0 <= b1) & (b1 <= ps[part + 1])).all()
    assert (b1 - b0 <= cap).all()
    # each partition has ceil(blocks / cap) chunks; an empty one keeps one
    per = np.bincount(part, minlength=kappa)
    assert (per == np.maximum(1, -(-nb // cap))).all()
    # partials: -1 for a whole partition, dense and consecutive in block
    # order for a split one; wsum heads each split partition's run
    split = per[part] > 1
    assert (pq[~split] == -1).all()
    assert sorted(pq[split]) == list(range(work.n_partials))
    for j in np.flatnonzero(per > 1):
        rows = np.flatnonzero(part == j)
        rows = rows[np.argsort(b0[rows])]
        first = pq[rows[0]]
        assert list(pq[rows]) == list(range(first, first + len(rows)))
        assert list(w[first]) == [j, len(rows)]
        assert (w[first + 1:first + len(rows)] == [-1, 0]).all()
    assert w[:, 1].sum() == work.n_partials
    # largest first
    assert (np.diff(b1 - b0) <= 0).all()


@pytest.mark.parametrize("name", sorted(TENSORS))
@pytest.mark.parametrize("cap", [1, 2, 5, None, 10**6])
def test_work_table_invariants(name, cap):
    """On Zipf tensors with a hot row and on uniform ones, every mode:
    coverage, chunk bounds, partial numbering, empty partitions, order."""
    for ps in _pstarts(TENSORS[name]):
        c = kmt.default_cap(int(ps[-1])) if cap is None else cap
        work = kmt.work_chunks(ps, c)
        _check_table(work, ps, c)
        assert work.chunks.dtype == work.wsum.dtype == torch.int32


def test_hot_partition_is_the_one_split():
    """At the cap of the second-largest partition only the hottest one is
    split, and its pieces come before every smaller chunk."""
    ps = _pstarts(TENSORS["zipf-hot"])[0]
    nb = np.diff(ps)
    work = kmt.work_chunks(ps, int(np.sort(nb)[-2]))
    heads = work.wsum[work.wsum[:, 1] > 0]
    assert heads[:, 0].tolist() == [int(nb.argmax())]
    c = work.chunks.numpy()
    sizes = c[:, 2] - c[:, 1]
    pos = np.flatnonzero(c[:, 0] == int(nb.argmax()))
    assert len(pos) == int(heads[0, 1]) == -(-nb.max() // np.sort(nb)[-2])
    assert pos.max() < (sizes >= sizes[pos].min()).sum()


def test_work_table_keeps_empty_partitions():
    """Partitions with no blocks (a hand-made table) and with one pad
    block (a compact plan) each keep exactly one chunk."""
    ps = np.array([0, 0, 3, 3, 3, 10, 11])
    for cap in (1, 3, 100):
        work = kmt.work_chunks(torch.from_numpy(ps), cap)
        _check_table(work, ps, cap)
        c = work.chunks
        for j in (0, 2, 3):
            assert c[c[:, 0] == j, 1:3].tolist() == [[ps[j], ps[j]]]
    t = TENSORS["uniform-empty"]
    assert any((p.part_nnz == 0).any() for p in t.plans)
    for ps in _pstarts(t):
        _check_table(kmt.work_chunks(ps, 1), ps, 1)


def test_work_table_refuses_bad_input():
    with pytest.raises(ValueError, match="cap"):
        kmt.split_partitions(np.array([0, 2]), 0)
    with pytest.raises(ValueError, match="nondecreasing"):
        kmt.split_partitions(np.array([0, 3, 2]), 4)
    with pytest.raises(ValueError, match="at least one"):
        kmt.work_from_chunks(np.zeros((0, 3)), np.array([0, 2]))


# pstart [0, 2, 2, 5]: partition 1 is empty. Each case is a chunk list
# (partition, first block, end block) with one range fault.
RANGE_FAULTS = {
    "partition below 0": ([(-1, 0, 2), (1, 2, 2), (2, 2, 5)], "partition -1"),
    "partition past kappa": ([(0, 0, 2), (1, 2, 2), (2, 2, 5), (3, 5, 5)],
                             "partition 3"),
    "block before its partition": ([(0, 0, 2), (1, 2, 2), (2, 1, 5)],
                                   "outside partition 2"),
    "block past its partition": ([(0, 0, 3), (1, 2, 2), (2, 3, 5)],
                                 "outside partition 0"),
    "block past nblocks": ([(0, 0, 2), (1, 2, 2), (2, 2, 6)],
                           "outside partition 2"),
    "end before begin": ([(0, 2, 0), (1, 2, 2), (2, 2, 5)],
                         "outside partition 0"),
    "missing partition": ([(0, 0, 2), (2, 2, 5)], "partition 1 has no"),
    "missing split partition": ([(1, 2, 2), (2, 2, 3), (2, 3, 5)],
                                "partition 0 has no"),
}


@pytest.mark.parametrize("fault", sorted(RANGE_FAULTS))
def test_work_from_chunks_refuses_a_range_fault(fault):
    """A chunk outside its partition, past ``nblocks``, naming no
    partition, or a partition with no chunk is refused where the table is
    built; the same list without the fault builds."""
    chunks, match = RANGE_FAULTS[fault]
    ps = np.array([0, 2, 2, 5])
    with pytest.raises(ValueError, match=match):
        kmt.work_from_chunks(chunks, ps)
    kmt.work_from_chunks([(0, 0, 2), (1, 2, 2), (2, 2, 3), (2, 3, 5)], ps)


def _set_partials(part, values):
    def fault(c, w):
        c[c[:, 0] == part, 3] = torch.tensor(values, dtype=torch.int32)
        return c, w
    return fault


def _set_wsum(row, values):
    def fault(c, w):
        w[row] = torch.tensor(values, dtype=torch.int32)
        return c, w
    return fault


# Faults of a table's partial indices and wsum, on the table of pstart
# [0, 3, 3, 7] at cap 2: partition 0 in [0, 2) and [2, 3) (partials 0,
# 1), partition 1 empty (-1), partition 2 in [3, 5) and [5, 7) (partials
# 2, 3); wsum [[0, 2], [-1, 0], [2, 2], [-1, 0]]. A partition's chunk
# rows are in table order, largest first: partition 2's in block order.
TABLE_FAULTS = {
    "partial on a whole partition": (_set_partials(1, [0]),
                                     "partial indices"),
    "split partition not numbered": (_set_partials(2, [-1, -1]),
                                     "partial indices"),
    "partials out of block order": (_set_partials(2, [3, 2]),
                                    "partial indices"),
    "partials not dense": (_set_partials(2, [3, 4]), "partial indices"),
    "wsum count": (_set_wsum(0, [0, 3]), "wsum disagrees"),
    "wsum partition": (_set_wsum(2, [1, 2]), "wsum disagrees"),
    "wsum extra row": (lambda c, w: (c, torch.cat(
        [w, torch.tensor([[-1, 0]], dtype=torch.int32)])), "wsum disagrees"),
    "wsum wrong shape": (lambda c, w: (c, w[:, :1]), "shape"),
}


@pytest.mark.parametrize("fault", sorted(TABLE_FAULTS))
def test_check_work_refuses_a_table_fault(fault):
    """``check_work`` holds a table's partial indices and ``wsum`` to what
    its chunks imply: dense, consecutive in block order, -1 for a whole
    partition."""
    ps = np.array([0, 3, 3, 7])
    work = kmt.work_chunks(ps, 2)
    assert work.wsum.tolist() == [[0, 2], [-1, 0], [2, 2], [-1, 0]]
    kmt.check_work(work, ps)
    edit, match = TABLE_FAULTS[fault]
    bad = kmt.WorkTable(*edit(work.chunks.clone(), work.wsum.clone()))
    with pytest.raises(ValueError, match=match):
        kmt.check_work(bad, ps)


@pytest.mark.parametrize("nblocks,cap", [(0, 1), (1, 1), (264, 1),
                                         (265, 2), (71_400, 271)])
def test_default_cap_is_half_an_sms_share(nblocks, cap):
    assert kmt.default_cap(nblocks) == cap


def _case(shape, fac, seed):
    (kappa, part_blocks, p), (nm1, r) = shape, fac
    c = _compact_case(seed, kappa, part_blocks, p, nm1, r)
    kw = dict(kappa=c["kappa"], rows_pp=c["rows_pp"], nblocks=c["nblocks"],
              block_p=c["p"])
    ps = np.concatenate([[0], np.cumsum(part_blocks)])
    return c, kw, ps


@pytest.mark.parametrize("shape,fac", CASES)
@pytest.mark.parametrize("cap", [1, 2])
def test_chunked_plain_matches_pallas_gather_compact(shape, fac, cap):
    """Split tables give the unsplit plain version's ``out_rel`` and the
    reference kernel's, within the reordering tolerance."""
    c, kw, ps = _case(shape, fac, shape[0] * 7 + fac[0])
    want = ops.mttkrp_fused_gather_compact(
        c["val"], c["lrow"], c["upos"], c["bpart"], c["uidx"], c["nuniq"],
        c["facs"], interpret=True, **kw)
    a = _port_args(c)
    work = kmt.work_chunks(ps, cap)
    assert (work.n_partials > 0) == (max(shape[1]) > cap)
    got = kmt.chunked_plain(a["val"], a["lrow"], a["upos"], a["bpart"],
                            a["uidx"], a["nuniq"], a["factors"], **kw,
                            work=work)
    plain = kmt.mttkrp_fused_gather_compact_plain(
        a["val"], a["lrow"], a["upos"], a["bpart"], a["uidx"], a["nuniq"],
        a["factors"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("shape,fac", CASES[:3])
@pytest.mark.parametrize("cap", [1, 3])
def test_chunked_plain_matches_pallas_remap_compact(shape, fac, cap):
    """The same with the remap: ``out_rel`` within the tolerance, the next
    layout bitwise equal to the reference kernel's."""
    c, kw, ps = _case(shape, fac, 13 * shape[0] + shape[2])
    idx, alpha, smax = _remap_inputs(c, shape[2] + fac[0])
    want = ops.mttkrp_fused_remap_compact(
        c["val"], idx, alpha, c["lrow"], c["upos"], c["bpart"], c["uidx"],
        c["nuniq"], c["facs"], interpret=True, smax=smax, next_mode=1, **kw)
    a = _port_args(c)
    got = kmt.chunked_plain(a["val"], a["lrow"], a["upos"], a["bpart"],
                            a["uidx"], a["nuniq"], a["factors"], **kw,
                            work=kmt.work_chunks(ps, cap),
                            remap=(_t(idx), _t(alpha), smax, 1))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _engine_mode(name, d=0, rank=16):
    """Mode ``d`` of ``TENSORS[name]`` as the engine lays it out on the
    CPU, with seeded factors."""
    t = TENSORS[name]
    state = engine.init(t, ExecutionConfig(backend="cuda_fused",
                                           device="cpu"), start_mode=d)
    rng = np.random.default_rng(d)
    facs = [torch.from_numpy(rng.standard_normal((n, rank))
                             .astype(np.float32)) for n in t.dims]
    L = mode_layout(state, (state.val, state.idx, state.alpha), d)
    plan = state.statics[d]
    kw = dict(kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
              block_p=plan.block_p)
    args = (L["val"], L["lrow"], L["upos"], L["bpart"], L["uidx"],
            L["nuniq"], tuple(f for w, f in enumerate(facs) if w != d))
    return state, L, args, kw


@pytest.mark.parametrize("name,d", [("zipf-hot", 0), ("zipf-hot", 2),
                                    ("zipf4", 1), ("uniform", 0)])
def test_chunked_plain_matches_plain_on_engine_layouts(name, d):
    """On the engine's own layouts, at the default cap and at one that
    splits only the hottest partition: ``chunked_plain`` equals the plain
    version, and the remap is bitwise the plain remap."""
    state, L, args, kw = _engine_mode(name, d)
    ps = L["pstart"].numpy()
    want = kmt.mttkrp_fused_gather_compact_plain(*args, **kw)
    nxt = (d + 1) % state.nmodes
    rwant = kmt.remap_plain(L["val"], L["idx"], L["alpha"], smax=state.smax,
                            next_mode=nxt)
    for cap in (kmt.default_cap(kw["nblocks"]),
                int(np.sort(np.diff(ps))[-2])):
        got = kmt.chunked_plain(*args, **kw, work=kmt.work_chunks(ps, cap),
                                remap=(L["idx"], L["alpha"], state.smax,
                                       nxt))
        torch.testing.assert_close(got[0], want, **TOL)
        for g, w in zip(got[1:], rwant):
            assert torch.equal(g, w)


@pytest.mark.parametrize("mutant", ["drop", "repeat"])
@pytest.mark.parametrize("name", ["zipf-hot", "zipf4"])
def test_mutant_tables_fail_the_tolerance(mutant, name):
    """A table that drops one of the hot partition's chunks, or lists one
    twice, changes that partition's rows beyond the tolerance (and no
    other partition's)."""
    _, L, args, kw = _engine_mode(name)
    ps = L["pstart"].numpy()
    nb = np.diff(ps)
    hot = int(nb.argmax())
    chunks = kmt.split_partitions(ps, int(np.sort(nb)[-2]))
    row = np.flatnonzero(chunks[:, 0] == hot)[1]
    chunks = (np.delete(chunks, row, 0) if mutant == "drop"
              else np.insert(chunks, row, chunks[row], 0))
    got = kmt.chunked_plain(*args, **kw,
                            work=kmt.work_from_chunks(chunks, ps))
    want = kmt.mttkrp_fused_gather_compact_plain(*args, **kw)
    rows = slice(hot * kw["rows_pp"], (hot + 1) * kw["rows_pp"])
    assert not torch.allclose(got[rows], want[rows], **TOL)
    keep = torch.ones(got.shape[0], dtype=torch.bool)
    keep[rows] = False
    torch.testing.assert_close(got[keep], want[keep], **TOL)


def _meta_args(rows_pp=4, nm1=2, r=32):
    """The balanced wrappers' arguments as meta tensors: a 2-partition,
    2-block plan (P = 8, R = 32, three modes)."""
    s = 16
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    args = (torch.empty(s, **meta), torch.empty((s, nm1 + 1), **i32),
            torch.empty((s, nm1 + 1), **i32), torch.empty(s, **i32),
            torch.empty((s, nm1), **i32), torch.empty(2, **i32),
            torch.empty((nm1, s), **i32), torch.empty((nm1, 2), **i32),
            tuple(torch.empty((5, r), **meta) for _ in range(nm1)))
    kw = dict(kappa=2, rows_pp=rows_pp, nblocks=2, block_p=8, smax=20,
              next_mode=1)
    return args, kw


def _meta_work(chunks=((0, 0, 1, -1), (1, 1, 2, -1)), wsum=(),
               dtype=torch.int32):
    """A table built by hand (never checked) on meta tensors."""
    return kmt.WorkTable(torch.tensor(chunks, dtype=dtype).reshape(-1, 4)
                         .to("meta"),
                         torch.tensor(wsum, dtype=torch.int32)
                         .reshape(-1, 2).to("meta"))


def _checked_meta_work():
    """``_meta_work()``'s table as ``work_chunks`` builds it for the plan
    of ``_meta_args`` (2 partitions of 1 block), checked and sealed, moved
    to meta tensors."""
    return kmt.work_chunks(np.array([0, 1, 2]), 1).to("meta")


@pytest.mark.parametrize("table,err,match", [
    (lambda: tuple(_meta_work()), TypeError, "WorkTable"),
    (lambda: _meta_work(dtype=torch.int64), TypeError, "dtype"),
    (lambda: kmt.WorkTable(_meta_work().chunks[:, :3], _meta_work().wsum),
     ValueError, "shape"),
    (lambda: kmt.WorkTable(torch.empty(8, dtype=torch.int32,
                                       device="meta"), _meta_work().wsum),
     ValueError, "shape"),
    (lambda: kmt.WorkTable(_meta_work().chunks,
                           torch.empty((1, 3), dtype=torch.int32,
                                       device="meta")),
     ValueError, "shape"),
    (lambda: kmt.WorkTable(torch.zeros((2, 4), dtype=torch.int32),
                           _meta_work().wsum), ValueError, "is on"),
    (lambda: _meta_work(chunks=((0, 0, 2, -1),)), ValueError,
     "every partition"),
])
@pytest.mark.parametrize("remap", [True, False])
def test_wrappers_refuse_a_malformed_work_table(table, err, match, remap):
    """Off the CPU the balanced wrappers check the table before the
    device (so meta tensors reach the check), then refuse to run
    anything but CUDA tensors, even with a checked table; nothing falls
    back or launches."""
    args, kw = _meta_args()
    before = dict(kmt.LAUNCHES)
    val, idx, alpha, lrow, upos, bpart, uidx, nuniq, facs = args
    gkw = {k: kw[k] for k in ("kappa", "rows_pp", "nblocks", "block_p")}
    call = (lambda w: kmt.mttkrp_fused_remap_compact(*args, **kw, work=w)
            ) if remap else (lambda w: kmt.mttkrp_fused_gather_compact(
                val, lrow, upos, bpart, uidx, nuniq, facs, **gkw, work=w))
    with pytest.raises(err, match=match):
        call(table())
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(_checked_meta_work())
    assert kmt.LAUNCHES == before


@pytest.mark.parametrize("nmodes,rank,block_p", [
    (3, 32, 128), (4, 32, 128), (5, 32, 128), (6, 16, 128), (6, 32, 128),
    (3, 64, 128), (7, 32, 128), (3, 32, 64)])
def test_plan_tile_and_launch_check_share_one_formula(nmodes, rank,
                                                      block_p):
    """``resolve_rows_pp`` fills the shared memory of the balanced kernel
    with the remap exactly: its rows fit and not one row more; without
    the remap they fit too, and so do the rect gather kernels' and the
    pre-gathered kernel's buffers."""
    cfg = ExecutionConfig(device="cpu", rank_hint=rank, block_p=block_p)
    rows = cfg.resolve_rows_pp(nmodes)
    nm1 = nmodes - 1
    need = kmt.balanced_smem_bytes(rows, rank, nm1, block_p, nmodes)
    assert need <= SMEM_PER_BLOCK < need + 4 * rank
    assert kmt.balanced_smem_bytes(rows, rank, nm1, block_p, 0) <= need
    for m in (0, nmodes):
        assert kmt.gather_smem_bytes(rows, rank, nm1, block_p, m) <= need
    assert kmt.pregathered_smem_bytes(rows, rank, nm1, block_p) <= need


@pytest.mark.parametrize("rank", [8, 32])
def test_wrapper_tile_limit_is_the_one_stage_formula(rank):
    """At P = 8 the largest tile that fits the one-stage kernel passes the
    check and one row more does not."""
    rows = (SMEM_PER_BLOCK - kmt.balanced_smem_bytes(0, rank, 2, 8, 3)
            ) // (4 * rank)
    args, kw = _meta_args(rows_pp=rows, r=rank)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kmt.mttkrp_fused_remap_compact(*args, **kw,
                                       work=_checked_meta_work())
    args, kw = _meta_args(rows_pp=rows + 1, r=rank)
    with pytest.raises(ValueError, match="does not fit"):
        kmt.mttkrp_fused_remap_compact(*args, **kw,
                                       work=_checked_meta_work())


@pytest.mark.parametrize("backend,has_work", [("cuda_fused", True),
                                              ("torch", False),
                                              ("cuda", True)])
def test_engine_init_builds_the_work_table(backend, has_work):
    """``engine.init`` keeps each mode's work table (chunks of at most
    ``default_cap`` blocks) only for the backends whose kernels take one;
    under compact ``cuda`` takes the balanced kernels' table."""
    t = TENSORS["zipf-hot"]
    state = engine.init(t, ExecutionConfig(backend=backend, device="cpu"))
    for p, s in zip(t.plans, state.sched):
        if not has_work:
            assert s.work is None and s.wsum is None
            continue
        want = mode_sched_arrays(p.block_part, p.kappa,
                                 t.dedup_tables(p.mode))
        ps = s.pstart.numpy()
        work = kmt.work_chunks(ps, kmt.default_cap(p.nblocks))
        assert torch.equal(s.work, work.chunks)
        assert torch.equal(s.wsum, work.wsum)
        assert np.array_equal(want.work, s.work.numpy())


def test_cuda_fused_backend_passes_the_state_table(monkeypatch):
    """The ``cuda_fused`` backend hands each mode's work table from the
    layout to both wrappers (on the CPU the wrappers then ignore it)."""
    seen = []
    for name in ("mttkrp_fused_remap_compact", "mttkrp_fused_gather_compact"):
        real = getattr(kmt, name)

        def spy(*a, _real=real, **k):
            seen.append(k["work"])
            return _real(*a, **k)

        monkeypatch.setattr(kmt, name, spy)
    t = TENSORS["zipf4"]
    rng = np.random.default_rng(0)
    facs = [torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
            for n in t.dims]
    for fuse in (True, False):
        state = engine.init(t, ExecutionConfig(backend="cuda_fused",
                                               device="cpu",
                                               fuse_remap=fuse))
        seen.clear()
        engine.all_modes(state, facs)
        assert len(seen) == t.nmodes
        for d, w in enumerate(seen):
            assert isinstance(w, kmt.WorkTable)
            assert w.chunks is state.sched[d].work
            assert w.wsum is state.sched[d].wsum
