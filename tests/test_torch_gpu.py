"""Card-only tests of the port: the CUDA kernels against their plain
versions (the compact in-kernel gather pair on the balanced kernels of
``csrc/mttkrp_balanced.cu``, with work tables that split every
partition, none or only the hot one; the pre-gathered and rect kernels
on the engine's tables and on tables that split every block or nothing,
against the plain versions of their schedule and with mutant tables; an
unchecked table refused by every wrapper), the ``cuda_fused`` and ``cuda``
rotations (both schedules) against the COO oracle, CPD on the card, the
RWKV-6 ``forward`` on the ``wkv6`` kernel, the RecurrentGemma
``forward`` on the ``lru_scan`` kernel, and the streaming tier (each
streamed mode against the resident engine and the oracle, host layouts
bitwise, one host wait a mode, ``cp_als_stream``, the event timeline),
and resilience on the card (``classify`` on a real
``torch.cuda.OutOfMemoryError``, the backend rung of ``cp_als``, the
stream's budget halving and upload retry, a resume), and the
CPD-factorized embedding (forward, its spMTTKRP backward, the CPD head)
and the dense attention family on the card against the CPU, and training
(the ``wkv6`` and ``lru_scan`` backward kernels against their plain
versions in float64, a train step on the card against the CPU's), and
the MoE family (a layer at full width, a smoke ``forward`` and
``Engine.prefill``, the expert-parallel sharded step), and the other
families (command-r's parallel block, paligemma's prefix-LM, whisper's
encoder-decoder: ``forward`` and ``Engine.prefill``, the int8 KV cache,
a train step and the sharded step, each against the CPU or the single
device), and the two CUDA graphs (``serving.Engine``'s replayed decode
step on bf16 working copies, bitwise the eager loop on the float32
masters; the ``all_modes`` rotation and ALS sweep replayed, against
eager mode steps, with and without ``donate``; each graph's pool freed
with its engine or state).
Every test is marked
``gpu`` and skips itself where torch sees no card. The file imports
neither ``jax`` nor ``repro``, so it runs on a machine with PyTorch and
the CUDA toolkit only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: ``out_rel`` and MTTKRP outputs rtol = atol = 2e-4 (float32
sums of at most a few hundred products, shared-memory atomics against
``index_add_``); remap outputs and layouts bitwise; CPD fits 1e-4;
``wkv6`` rtol = atol = 1e-4 against its plain version and its twin
``wkv6_grouped`` (the same float32 recurrence, the readout summed in
another order and the state update fused into one FMA);
the float32 ``forward`` on the card against the CPU rtol = atol = 2e-3:
the per-head RMS norm divides by |y|, so where y nearly cancels it
carries that sum's condition number into the logits (at t = 0,
y = (r . (u * k)) v is one dot product times v); 2.8e-4 was seen at
position 1 on an H100, a wrong decay or bonus moves logits by ~1e-1.
``lru_scan`` rtol = atol = 1e-5 (the same float32 recurrence, the
kernel's multiply-add fused into one rounding; the state stays below
~30 at these inputs, so ~1e-6 is expected); the float32 RecurrentGemma
``forward`` on the card against the CPU rtol = atol = 1e-3 (matmul sums
over d = 128 in another order through 38 layers, on logits of size ~1;
a dropped carry or a wrong mask moves them by ~1e-1), and against
``Engine.prefill`` on the card rtol = atol = 1e-4. The backward kernels
against their plain versions computed in float64: ``wkv6_bwd`` rtol =
atol = 1e-4 (float32 sums over up to 4096 steps of states of size ~10-100,
the plain version's sums exact to float64; du, a sum over T that cancels,
is summed in double by the kernel), ``lru_scan_bwd`` rtol = atol = 1e-5
(one FMA a step, gradients below ~30). The other families: as the MoE
family's and sharded training's (stated at each test).
"""
import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.core import build_flycoo, cp_als, mttkrp_ref, zipf_tensor
from repro_torch.core.flycoo import _ROW_SENTINEL, _dedup_tables_batched
from repro_torch.engine import ExecutionConfig
from repro_torch.engine.api import mode_layout
from repro_torch.kernels import mttkrp as kmt
from repro_torch.kernels import lru_scan as klru
from repro_torch.kernels import wkv6 as kw6

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_case(seed, part_blocks, p, nm1, r, rows_pp=8, empty=None):
    """Compact-schedule kernel inputs with hot factor rows (so blocks
    dedup); partition ``empty`` (if given) holds only pad slots."""
    rng = np.random.default_rng(seed)
    kappa, nblocks = len(part_blocks), sum(part_blocks)
    s = nblocks * p
    bpart = np.repeat(np.arange(kappa), part_blocks).astype(np.int32)
    dims_in = [int(d) for d in rng.integers(8, 40, nm1)]
    facs = [rng.standard_normal((d, r)).astype(np.float32) for d in dims_in]
    lidx = np.stack([np.where(rng.random(s) < 0.7, rng.integers(0, 4, s),
                              rng.integers(0, d, s)) for d in dims_in])
    lrow = rng.integers(-1, rows_pp, s).astype(np.int32)
    if empty is not None:
        lrow[np.repeat(bpart, p) == empty] = -1
    val = np.where(lrow < 0, 0, rng.standard_normal(s)).astype(np.float32)
    rows = np.where(lrow[None, :] < 0, _ROW_SENTINEL, lidx)
    uidx, upos, nuniq = _dedup_tables_batched(rows, nblocks, p)
    n = nm1 + 1
    smax = s + 24
    alive = lrow >= 0
    idx = rng.integers(0, 50, (s, n)).astype(np.int32)
    alpha = np.full((s, n), -1, np.int32)
    alpha[alive] = rng.integers(0, smax, (int(alive.sum()), n))
    alpha[alive, 1] = rng.permutation(smax)[: int(alive.sum())]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = (t(val), t(idx), t(alpha), t(lrow), t(upos.T), t(bpart), t(uidx),
            t(nuniq), tuple(t(f) for f in facs))
    kw = dict(kappa=kappa, rows_pp=rows_pp, nblocks=nblocks, block_p=p,
              smax=smax, next_mode=1)
    return args, kw


@pytest.mark.gpu
@pytest.mark.parametrize("part_blocks,p,nm1,r,empty", [
    ((3, 1), 8, 2, 8, None), ((1, 4, 2, 1), 16, 3, 32, None),
    ((2, 1, 5), 32, 5, 16, None), ((1, 2, 1), 128, 2, 32, 0),
    ((2, 3), 128, 4, 64, 1), ((2, 3), 16, 2, 10, None),
    ((2, 3, 1), 48, 2, 256, None), ((2, 3, 1), 64, 2, 256, 2)])
def test_cuda_kernels_match_plain(cuda, part_blocks, p, nm1, r, empty):
    """The compact in-kernel gather pair (``csrc/mttkrp_balanced.cu``,
    its work table derived from ``bpart`` by the wrappers) against the
    plain versions; at R = 10 the factor rows are copied 4 bytes at a
    time, and the last two cases' factor-row stages (R = 256) take 96 and
    128 KB of the shared memory."""
    args, kw = _kernel_case(len(part_blocks) * 11 + nm1, part_blocks, p,
                            nm1, r, empty=empty)
    args = tuple(a.to(cuda) if torch.is_tensor(a)
                 else tuple(f.to(cuda) for f in a) for a in args)
    val, idx, alpha, lrow, upos, bpart, uidx, nuniq, facs = args
    gkw = {k: kw[k] for k in ("kappa", "rows_pp", "nblocks", "block_p")}
    before = dict(kmt.LAUNCHES)
    got = kmt.mttkrp_fused_remap_compact(*args, **kw)
    gat = kmt.mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx,
                                          nuniq, facs, **gkw)
    want = kmt.mttkrp_fused_remap_compact_plain(*args, **kw)
    torch.cuda.synchronize()
    for k in ("mttkrp_fused_remap_compact", "mttkrp_fused_gather_compact"):
        assert kmt.LAUNCHES[k] == before[k] + 1
    torch.testing.assert_close(got[0], want[0], **TOL)
    torch.testing.assert_close(gat, want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    if empty is not None:
        rows = slice(empty * kw["rows_pp"], (empty + 1) * kw["rows_pp"])
        assert not got[0][rows].any() and not gat[rows].any()


@pytest.mark.gpu
def test_cuda_wrapper_raises_never_falls_back(cuda):
    """The balanced kernels' wrapper refuses bad arguments and a tile
    that does not fit, on the card, before any launch."""
    args, kw = _kernel_case(3, (2, 1), 16, 2, 32)
    args = tuple(a.to(cuda) if torch.is_tensor(a)
                 else tuple(f.to(cuda) for f in a) for a in args)
    val, idx, alpha, lrow, upos, bpart, uidx, nuniq, facs = args
    gkw = {k: kw[k] for k in ("kappa", "rows_pp", "nblocks", "block_p")}
    bad = (facs[0], facs[1].T.contiguous().T)          # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        kmt.mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx, nuniq,
                                        bad, **gkw)
    with pytest.raises(TypeError, match="dtype"):
        kmt.mttkrp_fused_gather_compact(val.double(), lrow, upos, bpart,
                                        uidx, nuniq, facs, **gkw)
    with pytest.raises(ValueError, match="does not fit"):
        kmt.mttkrp_fused_gather_compact(
            val, lrow, upos, bpart, uidx, nuniq, facs,
            **dict(gkw, rows_pp=4000))


def _hot_tensor():
    """A 3-mode Zipf tensor whose hottest partition holds about twice the
    blocks of the next (mode 0: 25 blocks against 12)."""
    return zipf_tensor((400, 300, 200), 30000, a=2.0, seed=4, rows_pp=16,
                       block_p=32)


def _balanced_case(kind, cuda):
    """Inputs of the two balanced wrappers and the host block-start
    table: ``hot`` is mode 0 of :func:`_hot_tensor` as ``engine.init``
    lays it out; ``empty`` a toy plan whose 4-block partition 1 holds only
    pad slots."""
    if kind == "empty":
        args, kw = _kernel_case(29, (1, 4, 2, 1), 16, 3, 32, empty=1)
        args = tuple(a.to(cuda) if torch.is_tensor(a)
                     else tuple(f.to(cuda) for f in a) for a in args)
        ps = kmt.block_starts(args[5].cpu(), kw["kappa"]).numpy()
        return args, kw, ps
    t = _hot_tensor()
    state = engine.init(t, ExecutionConfig(backend="cuda_fused"))
    g = torch.Generator(device="cuda").manual_seed(7)
    facs = [torch.randn((d, 32), generator=g, device="cuda")
            for d in t.dims]
    L = mode_layout(state, (state.val, state.idx, state.alpha), 0)
    plan = state.statics[0]
    args = (L["val"], L["idx"], L["alpha"], L["lrow"], L["upos"],
            L["bpart"], L["uidx"], L["nuniq"], tuple(facs[1:]))
    kw = dict(kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
              block_p=plan.block_p, smax=state.smax, next_mode=1)
    return args, kw, L["pstart"].cpu().numpy()


def _caps(ps):
    """Chunk caps that split every multi-block partition, none, and only
    the hottest."""
    nb = np.sort(np.diff(ps))
    return {"every": 1, "none": int(nb[-1]), "hot": int(nb[-2])}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hot", "empty"])
@pytest.mark.parametrize("split", ["every", "none", "hot"])
def test_balanced_kernels_match_plain(cuda, kind, split):
    """``mttkrp_fused_remap_compact`` and ``mttkrp_fused_gather_compact``
    on a given work table against the plain versions and against
    ``chunked_plain`` on the same table; one launch each, and the second
    pass once each where a partition is split."""
    args, kw, ps = _balanced_case(kind, cuda)
    cap = _caps(ps)[split]
    work = kmt.work_chunks(ps, cap).to(cuda)
    nsplit = int((work.wsum[:, 1] > 0).sum())
    nb = np.diff(ps)
    assert nsplit == {"every": int((nb > 1).sum()), "none": 0,
                      "hot": 1}[split]
    val, idx, alpha, lrow, upos, bpart, uidx, nuniq, facs = args
    gkw = {k: kw[k] for k in ("kappa", "rows_pp", "nblocks", "block_p")}
    before = dict(kmt.LAUNCHES)
    got = kmt.mttkrp_fused_remap_compact(*args, **kw, work=work)
    gat = kmt.mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx,
                                          nuniq, facs, **gkw, work=work)
    want = kmt.mttkrp_fused_remap_compact_plain(*args, **kw)
    chunked = kmt.chunked_plain(val, lrow, upos, bpart, uidx, nuniq, facs,
                                **gkw, work=work,
                                remap=(idx, alpha, kw["smax"],
                                       kw["next_mode"]))
    torch.cuda.synchronize()
    for k in ("mttkrp_fused_remap_compact", "mttkrp_fused_gather_compact"):
        assert kmt.LAUNCHES[k] == before[k] + 1
    assert (kmt.LAUNCHES["mttkrp_balanced_reduce"]
            == before["mttkrp_balanced_reduce"] + 2 * (nsplit > 0))
    for out in (got[0], gat, chunked[0]):
        torch.testing.assert_close(out, want[0], **TOL)
    for g, w, c in zip(got[1:], want[1:], chunked[1:]):
        assert torch.equal(g, w) and torch.equal(c, w)
    if kind == "empty":
        rows = slice(kw["rows_pp"], 2 * kw["rows_pp"])
        assert not got[0][rows].any() and not gat[rows].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mutant", ["drop", "repeat"])
def test_balanced_kernel_follows_its_table(cuda, mutant):
    """A table that drops one of the hot partition's chunks, or lists one
    twice: the kernel does what the table says (``chunked_plain`` on the
    same table), and the hot partition's rows then miss the plain
    version's, so a check against it catches the table."""
    args, kw, ps = _balanced_case("hot", cuda)
    nb = np.diff(ps)
    hot = int(nb.argmax())
    chunks = kmt.split_partitions(ps, _caps(ps)["hot"])
    row = np.flatnonzero(chunks[:, 0] == hot)[1]
    chunks = (np.delete(chunks, row, 0) if mutant == "drop"
              else np.insert(chunks, row, chunks[row], 0))
    work = kmt.work_from_chunks(chunks, ps).to(cuda)
    val, idx, alpha, lrow, upos, bpart, uidx, nuniq, facs = args
    gkw = {k: kw[k] for k in ("kappa", "rows_pp", "nblocks", "block_p")}
    got = kmt.mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx,
                                          nuniq, facs, **gkw, work=work)
    want = kmt.mttkrp_fused_gather_compact_plain(val, lrow, upos, bpart,
                                                 uidx, nuniq, facs, **gkw)
    torch.testing.assert_close(
        got, kmt.chunked_plain(val, lrow, upos, bpart, uidx, nuniq, facs,
                               **gkw, work=work), **TOL)
    rows = slice(hot * kw["rows_pp"], (hot + 1) * kw["rows_pp"])
    assert not torch.allclose(got[rows], want[rows], **TOL)
    keep = torch.ones(got.shape[0], dtype=torch.bool, device=cuda)
    keep[rows] = False
    torch.testing.assert_close(got[keep], want[keep], **TOL)


@pytest.mark.gpu
def test_balanced_refuses_a_malformed_table(cuda):
    """A work table of the wrong kind, dtype, shape, device or layout, or
    with fewer chunks than partitions, raises before any launch; nothing
    falls back to the plain version."""
    args, kw, ps = _balanced_case("hot", cuda)
    work = kmt.work_chunks(ps, 4).to(cuda)
    c, w = work.chunks, work.wsum
    bad = [(TypeError, tuple(work)),
           (TypeError, kmt.WorkTable(c.long(), w)),
           (ValueError, kmt.WorkTable(c[:, :3].contiguous(), w)),
           (ValueError, kmt.WorkTable(c, torch.zeros((2, 3), dtype=torch.int32,
                                                     device=cuda))),
           (ValueError, kmt.WorkTable(c.cpu(), w)),
           (ValueError, kmt.WorkTable(c.t().contiguous().t(), w)),
           (ValueError, kmt.WorkTable(c[: kw["kappa"] - 1].contiguous(),
                                      w))]
    before = dict(kmt.LAUNCHES)
    for err, table in bad:
        with pytest.raises(err):
            kmt.mttkrp_fused_remap_compact(*args, **kw, work=table)
    assert kmt.LAUNCHES == before


@pytest.mark.gpu
def test_engine_rotation_uses_the_state_work_table(cuda, monkeypatch):
    """The main path: ``engine.init`` keeps each mode's work table on the
    card, and the rotation launches ``mttkrp_fused_remap_compact`` (and
    the second pass) with it, never deriving one (no host sync); the
    outputs match ``mttkrp_ref`` and the layout comes back bitwise."""
    t = _hot_tensor()
    state = engine.init(t, ExecutionConfig(backend="cuda_fused"))
    assert all(s.work.is_cuda and s.wsum.is_cuda for s in state.sched)

    def derive(*a, **k):
        raise AssertionError("the engine path derived a work table")

    monkeypatch.setattr(kmt, "work_chunks", derive)
    g = torch.Generator(device="cuda").manual_seed(3)
    facs = [torch.randn((d, 32), generator=g, device="cuda") for d in t.dims]
    before = dict(kmt.LAUNCHES)
    outs, nxt = engine.all_modes(state, facs)
    torch.cuda.synchronize()
    name = "mttkrp_fused_remap_compact"
    assert kmt.LAUNCHES[name] == before[name] + 3
    assert (kmt.LAUNCHES["mttkrp_balanced_reduce"]
            == before["mttkrp_balanced_reduce"]
            + sum(s.wsum.shape[0] > 0 for s in state.sched))
    ti = torch.from_numpy(t.indices).to(cuda)
    tv = torch.from_numpy(t.values).to(cuda)
    for d in range(3):
        torch.testing.assert_close(
            outs[d], mttkrp_ref(ti, tv, facs, d, t.dims[d]), **TOL)
    for a in ("val", "idx", "alpha"):
        assert torch.equal(getattr(nxt, a), getattr(state, a))


def _rect_case(seed, kappa, blocks_pp, p, nm1, r, rows_pp=8, empty=None):
    """Rect-schedule inputs: each partition's alive slots first, then pads
    (as a rect plan lays them out), hot factor rows; partition ``empty``
    (if given) holds only pads. Returns the tensors of every rect and
    pre-gathered wrapper."""
    rng = np.random.default_rng(seed)
    s = kappa * blocks_pp * p
    dims_in = [int(d) for d in rng.integers(8, 40, nm1)]
    facs = [rng.standard_normal((d, r)).astype(np.float32) for d in dims_in]
    lidx = np.stack([np.where(rng.random(s) < 0.7, rng.integers(0, 4, s),
                              rng.integers(0, d, s))
                     for d in dims_in]).astype(np.int32)
    fill = rng.integers(0, blocks_pp * p + 1, kappa)
    if empty is not None:
        fill[empty] = 0
    local = np.arange(s) % (blocks_pp * p)
    lrow = np.where(local < np.repeat(fill, blocks_pp * p),
                    rng.integers(0, rows_pp, s), -1).astype(np.int32)
    val = np.where(lrow < 0, 0, rng.standard_normal(s)).astype(np.float32)
    n = nm1 + 1
    smax = s + 24
    alive = lrow >= 0
    idx = rng.integers(0, 50, (s, n)).astype(np.int32)
    alpha = np.full((s, n), -1, np.int32)
    alpha[alive] = rng.integers(0, smax, (int(alive.sum()), n))
    alpha[alive, 1] = rng.permutation(smax)[: int(alive.sum())]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    gathered = np.stack([facs[w][lidx[w]] for w in range(nm1)], axis=1)
    bpart = np.repeat(np.arange(kappa), blocks_pp).astype(np.int32)
    return (dict(val=t(val), idx=t(idx), alpha=t(alpha), lrow=t(lrow),
                 lidx=t(lidx), gathered=t(gathered), bpart=t(bpart),
                 facs=tuple(t(f) for f in facs)),
            dict(kappa=kappa, rows_pp=rows_pp, blocks_pp=blocks_pp,
                 block_p=p, smax=smax, next_mode=1))


@pytest.mark.gpu
@pytest.mark.parametrize("kappa,blocks_pp,p,nm1,r,empty", [
    (2, 1, 8, 2, 8, None), (4, 3, 16, 3, 32, None), (3, 2, 32, 5, 16, 1),
    (3, 2, 128, 2, 32, 0), (2, 3, 128, 4, 64, None)])
def test_cuda_rect_and_pregathered_kernels_match_plain(cuda, kappa,
                                                       blocks_pp, p, nm1, r,
                                                       empty):
    """``mttkrp_fused_remap``, ``mttkrp_fused_gather``, ``mttkrp_fused``
    and ``mttkrp_fused_compact`` (on the rect plan's descriptor, which
    the compact kernel walks alike) against their plain versions, each
    launching once."""
    a, kw = _rect_case(kappa * 13 + nm1, kappa, blocks_pp, p, nm1, r,
                       empty=empty)
    a = {k: (tuple(f.to(cuda) for f in v) if k == "facs" else v.to(cuda))
         for k, v in a.items()}
    rect = {k: kw[k] for k in ("kappa", "rows_pp", "blocks_pp", "block_p")}
    comp = dict(kappa=kappa, rows_pp=kw["rows_pp"],
                nblocks=kappa * blocks_pp, block_p=p)
    remap = (a["val"], a["idx"], a["alpha"], a["lrow"], a["lidx"], a["facs"])
    before = dict(kmt.LAUNCHES)
    got = {
        "mttkrp_fused_remap": kmt.mttkrp_fused_remap(*remap, **kw),
        "mttkrp_fused_gather": kmt.mttkrp_fused_gather(
            a["val"], a["lrow"], a["lidx"], a["facs"], **rect),
        "mttkrp_fused": kmt.mttkrp_fused(a["gathered"], a["val"], a["lrow"],
                                         **rect),
        "mttkrp_fused_compact": kmt.mttkrp_fused_compact(
            a["gathered"], a["val"], a["lrow"], a["bpart"], **comp)}
    want = kmt.mttkrp_fused_remap_plain(*remap, **kw)
    torch.cuda.synchronize()
    for k in got:
        assert kmt.LAUNCHES[k] == before[k] + 1
        out = got[k][0] if k == "mttkrp_fused_remap" else got[k]
        torch.testing.assert_close(out, want[0], **TOL)
        if empty is not None:
            rows = slice(empty * kw["rows_pp"], (empty + 1) * kw["rows_pp"])
            assert not out[rows].any()
    for g, w in zip(got["mttkrp_fused_remap"][1:], want[1:]):
        assert torch.equal(g, w)
    torch.testing.assert_close(
        kmt.mttkrp_fused_plain(a["gathered"], a["val"], a["lrow"], **rect),
        want[0], **TOL)


NEW = ("mttkrp_fused", "mttkrp_fused_compact", "mttkrp_fused_gather",
       "mttkrp_fused_remap")


def _new_case(name, cuda, d=0):
    """Mode ``d`` of :func:`_hot_tensor` as ``engine.init`` lays it out
    for kernel ``name``'s backend: rect ``cuda_fused`` for the rect
    kernels (``mttkrp_fused`` runs on the same layout and table), compact
    ``cuda`` for ``mttkrp_fused_compact``. Returns the state, the layout,
    the factors and the plan."""
    schedule = "compact" if name == "mttkrp_fused_compact" else "rect"
    t = zipf_tensor((400, 300, 200), 30000, a=2.0, seed=4, rows_pp=16,
                    block_p=32, schedule=schedule)
    backend = "cuda" if schedule == "compact" else "cuda_fused"
    state = engine.init(t, ExecutionConfig(backend=backend), start_mode=d)
    g = torch.Generator(device="cuda").manual_seed(5)
    facs = [torch.randn((n, 32), generator=g, device="cuda")
            for n in t.dims]
    L = mode_layout(state, (state.val, state.idx, state.alpha), d)
    return state, L, facs, t.plans[d]


def _new_run(name, state, L, facs, d, how, work=None):
    """Kernel ``name`` on ``work`` (``how="kernel"``), its plain version
    (``"plain"``) or the plain version of its schedule on ``work``
    (``"chunked"``)."""
    from repro_torch.engine.backends import fused_lidx, pregather

    plan = state.statics[d]
    inputs = tuple(f for w, f in enumerate(facs) if w != d)
    rect = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                blocks_pp=plan.blocks_pp, block_p=plan.block_p)
    sched = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                 block_p=plan.block_p, work=work)
    extra = {"work": work} if how == "kernel" else {}
    fn = getattr(kmt, name + ("_plain" if how == "plain" else ""))
    remap = (L["idx"], L["alpha"], state.smax, (d + 1) % len(facs))
    if name in ("mttkrp_fused", "mttkrp_fused_compact"):
        g = pregather(L["idx"], facs, d)
        if how == "chunked":
            return kmt.chunked_plain_pregathered(g, L["val"], L["lrow"],
                                                 **sched)
        if name == "mttkrp_fused":
            return fn(g, L["val"], L["lrow"], **rect, **extra)
        return fn(g, L["val"], L["lrow"], L["bpart"], kappa=plan.kappa,
                  rows_pp=plan.rows_pp, nblocks=plan.nblocks,
                  block_p=plan.block_p, **extra)
    lidx = fused_lidx(L["idx"], d)
    if how == "chunked":
        return kmt.chunked_plain_gather(
            L["val"], L["lrow"], lidx, inputs, **sched,
            remap=remap if name == "mttkrp_fused_remap" else None)
    if name == "mttkrp_fused_gather":
        return fn(L["val"], L["lrow"], lidx, inputs, **rect, **extra)
    return fn(L["val"], L["idx"], L["alpha"], L["lrow"], lidx, inputs,
              smax=remap[2], next_mode=remap[3], **rect, **extra)


def _new_table(split, L, plan):
    """The state's table, or the same blocks cut into chunks of one
    block (``every``) or not cut at all (``none``)."""
    if split == "state":
        return kmt.WorkTable(L["work"], L["wsum"])
    ps = L["pstart"].cpu().numpy()
    if plan.schedule == "rect":
        begin = ps[:-1]
        end = begin + -(-plan.part_nnz // plan.block_p)
    else:
        begin, end = ps[:-1], ps[1:]
    cap = 1 if split == "every" else int((end - begin).max())
    return kmt.work_from_chunks(kmt.split_ranges(begin, end, cap),
                                ps).to(L["val"].device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("split", ["state", "every", "none"])
def test_new_kernels_match_plain_and_their_schedule(cuda, name, split):
    """The pre-gathered kernel (both schedules) and the rect gather pair
    (``csrc/mttkrp_pregathered.cu``, ``csrc/mttkrp_gather.cu``) on the
    engine's table (under rect, only the alive extents), on one that cuts
    every block apart, and on one that splits nothing: each against its
    plain version and against the plain version of its schedule on the
    same table, the remap bitwise; one launch each, and the second pass
    once where a partition is split."""
    state, L, facs, plan = _new_case(name, cuda)
    work = _new_table(split, L, plan)
    nsplit = int((work.wsum[:, 1] > 0).sum())
    assert (nsplit > 0) == (split != "none")
    before = dict(kmt.LAUNCHES)
    got = _new_run(name, state, L, facs, 0, "kernel", work)
    want = _new_run(name, state, L, facs, 0, "plain")
    chunked = _new_run(name, state, L, facs, 0, "chunked", work)
    torch.cuda.synchronize()
    assert kmt.LAUNCHES[name] == before[name] + 1
    assert (kmt.LAUNCHES["mttkrp_balanced_reduce"]
            == before["mttkrp_balanced_reduce"] + (nsplit > 0))
    if name == "mttkrp_fused_remap":
        for g, w, c in zip(got[1:], want[1:], chunked[1:]):
            assert torch.equal(g, w) and torch.equal(c, w)
        got, want, chunked = got[0], want[0], chunked[0]
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(chunked, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("mutant", ["drop", "repeat"])
def test_new_kernels_follow_their_table(cuda, name, mutant):
    """A table that drops one of the hot partition's chunks, or lists one
    twice: the kernel does what the table says (the plain version of its
    schedule on the same table), and the hot partition's rows then miss
    the plain version's, so a check against it catches the table."""
    state, L, facs, plan = _new_case(name, cuda)
    hot = int(plan.part_nnz.argmax())
    c = L["work"].cpu().numpy()[:, :3].astype(np.int64)
    chunks = c[np.lexsort((c[:, 1], c[:, 0]))]
    row = np.flatnonzero(chunks[:, 0] == hot)[1]
    chunks = (np.delete(chunks, row, 0) if mutant == "drop"
              else np.insert(chunks, row, chunks[row], 0))
    work = kmt.work_from_chunks(chunks, L["pstart"].cpu().numpy()).to(cuda)
    got, want, chunked = (_new_run(name, state, L, facs, 0, how, work)
                          for how in ("kernel", "plain", "chunked"))
    if name == "mttkrp_fused_remap":   # out_rel only
        got, want, chunked = got[0], want[0], chunked[0]
    torch.testing.assert_close(got, chunked, **TOL)
    rows = slice(hot * plan.rows_pp, (hot + 1) * plan.rows_pp)
    assert not torch.allclose(got[rows], want[rows], **TOL)
    keep = torch.ones(got.shape[0], dtype=torch.bool, device=cuda)
    keep[rows] = False
    torch.testing.assert_close(got[keep], want[keep], **TOL)


# Hand-built tables for a 2-partition, 2-block plan, each with one fault
# that check_work refuses, in a well-formed shape.
UNCHECKED = {
    "partition out of range": ((0, 0, 1, -1), (2, 1, 2, -1)),
    "blocks outside their partition": ((0, 0, 2, -1), (1, 1, 2, -1)),
    "partition missing": ((0, 0, 1, -1), (0, 1, 2, -1)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(UNCHECKED))
def test_wrappers_refuse_an_unchecked_table_on_the_card(cuda, fault):
    """On the card every wrapper that takes ``work=`` refuses a table that
    never passed ``check_work`` before any launch, whatever its fault;
    the same wrappers run on the checked table of the same plan."""
    a, kw = _rect_case(41, 2, 1, 8, 2, 8)
    a = {k: (tuple(f.to(cuda) for f in v) if k == "facs" else v.to(cuda))
         for k, v in a.items()}
    rect = {k: kw[k] for k in ("kappa", "rows_pp", "blocks_pp", "block_p")}
    comp = dict(kappa=2, rows_pp=kw["rows_pp"], nblocks=2, block_p=8)
    args, ckw = _kernel_case(43, (1, 1), 8, 2, 8)
    args = tuple(x.to(cuda) if torch.is_tensor(x)
                 else tuple(f.to(cuda) for f in x) for x in args)
    val, idx, alpha, lrow, upos, bpart, uidx, nuniq, facs = args
    gkw = {k: ckw[k] for k in ("kappa", "rows_pp", "nblocks", "block_p")}
    remap = (a["val"], a["idx"], a["alpha"], a["lrow"], a["lidx"], a["facs"])
    calls = {
        "mttkrp_fused": lambda w: kmt.mttkrp_fused(
            a["gathered"], a["val"], a["lrow"], **rect, work=w),
        "mttkrp_fused_compact": lambda w: kmt.mttkrp_fused_compact(
            a["gathered"], a["val"], a["lrow"], a["bpart"], **comp, work=w),
        "mttkrp_fused_gather": lambda w: kmt.mttkrp_fused_gather(
            a["val"], a["lrow"], a["lidx"], a["facs"], **rect, work=w),
        "mttkrp_fused_remap": lambda w: kmt.mttkrp_fused_remap(
            *remap, **kw, work=w),
        "mttkrp_fused_gather_compact": lambda w:
            kmt.mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx,
                                            nuniq, facs, **gkw, work=w),
        "mttkrp_fused_remap_compact": lambda w:
            kmt.mttkrp_fused_remap_compact(*args, **ckw, work=w)}
    bad = kmt.WorkTable(
        torch.tensor(UNCHECKED[fault], dtype=torch.int32, device=cuda),
        torch.zeros((0, 2), dtype=torch.int32, device=cuda))
    before = dict(kmt.LAUNCHES)
    for name, call in calls.items():
        with pytest.raises(ValueError, match="check_work passed"):
            call(bad)
    torch.cuda.synchronize()
    assert kmt.LAUNCHES == before
    good = kmt.work_chunks(np.array([0, 1, 2]), 1).to(cuda)
    for name, call in calls.items():
        call(good)
        assert kmt.LAUNCHES[name] == before[name] + 1
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("backend,schedule,fuse,name", [
    ("cuda", "compact", True, "mttkrp_fused_compact"),
    ("cuda", "rect", True, "mttkrp_fused"),
    ("cuda_fused", "rect", True, "mttkrp_fused_remap"),
    ("cuda_fused", "rect", False, "mttkrp_fused_gather")])
def test_engine_rotation_uses_the_state_table_for_cuda_and_rect(
        cuda, monkeypatch, backend, schedule, fuse, name):
    """``engine.init`` keeps the ``cuda`` and rect tables on the card, and
    the rotation launches the kernel (and the second pass) with them,
    never deriving one (no host sync); the outputs match ``mttkrp_ref``
    and the layout comes back bitwise."""
    t = zipf_tensor((400, 300, 200), 30000, a=2.0, seed=4, rows_pp=16,
                    block_p=32, schedule=schedule)
    state = engine.init(t, ExecutionConfig(backend=backend,
                                           fuse_remap=fuse))
    assert all(s.work.is_cuda and s.wsum.is_cuda for s in state.sched)

    def derive(*a, **k):
        raise AssertionError("the engine path derived a work table")

    monkeypatch.setattr(kmt, "work_chunks", derive)
    g = torch.Generator(device="cuda").manual_seed(3)
    facs = [torch.randn((d, 32), generator=g, device="cuda") for d in t.dims]
    before = dict(kmt.LAUNCHES)
    outs, nxt = engine.all_modes(state, facs)
    torch.cuda.synchronize()
    assert kmt.LAUNCHES[name] == before[name] + 3
    assert (kmt.LAUNCHES["mttkrp_balanced_reduce"]
            == before["mttkrp_balanced_reduce"]
            + sum(s.wsum.shape[0] > 0 for s in state.sched))
    ti = torch.from_numpy(t.indices).to(cuda)
    tv = torch.from_numpy(t.values).to(cuda)
    for d in range(3):
        torch.testing.assert_close(
            outs[d], mttkrp_ref(ti, tv, facs, d, t.dims[d]), **TOL)
    for a in ("val", "idx", "alpha"):
        assert torch.equal(getattr(nxt, a), getattr(state, a))


def _coo(nmodes, nnz, seed):
    dims = {3: (23, 17, 11), 4: (13, 11, 7, 9), 5: (9, 8, 7, 6, 5),
            6: (7, 6, 5, 4, 3, 8)}[nmodes]
    rng = np.random.default_rng(seed)
    idx = np.unique(np.stack([rng.integers(0, d, nnz) for d in dims], 1)
                    .astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    return idx, val, dims, rng


@pytest.mark.gpu
@pytest.mark.parametrize("nmodes", [3, 4, 5, 6])
def test_cuda_rotation_launches_kernels_and_matches_oracle(cuda, nmodes):
    idx, val, dims, rng = _coo(nmodes, 2000, nmodes)
    t = build_flycoo(idx, val, dims, rows_pp=4, block_p=8)
    facs = [torch.from_numpy(rng.standard_normal((d, 32))
                             .astype(np.float32)).to(cuda) for d in dims]
    ti, tv = torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda)
    for fuse, name in ((True, "mttkrp_fused_remap_compact"),
                       (False, "mttkrp_fused_gather_compact")):
        state = engine.init(t, ExecutionConfig(backend="cuda_fused",
                                               fuse_remap=fuse),
                            start_mode=nmodes - 1)
        before = kmt.LAUNCHES[name]
        outs, nxt = engine.all_modes(state, facs)
        torch.cuda.synchronize()
        assert kmt.LAUNCHES[name] == before + nmodes
        for d in range(nmodes):
            torch.testing.assert_close(
                outs[d], mttkrp_ref(ti, tv, facs, d, dims[d]), **TOL)
        for a in ("val", "idx", "alpha"):
            assert torch.equal(getattr(nxt, a), getattr(state, a))


@pytest.mark.gpu
@pytest.mark.parametrize("backend,schedule,fuse,name", [
    ("cuda_fused", "rect", True, "mttkrp_fused_remap"),
    ("cuda_fused", "rect", False, "mttkrp_fused_gather"),
    ("cuda", "rect", True, "mttkrp_fused"),
    ("cuda", "compact", True, "mttkrp_fused_compact")])
@pytest.mark.parametrize("nmodes", [3, 5])
def test_cuda_rect_and_baseline_rotations_match_oracle(cuda, backend,
                                                       schedule, fuse, name,
                                                       nmodes):
    from repro_torch.engine import PlanSpec, make_engine

    idx, val, dims, rng = _coo(nmodes, 2000, nmodes + 7)
    facs = [torch.from_numpy(rng.standard_normal((d, 32))
                             .astype(np.float32)).to(cuda) for d in dims]
    ti, tv = torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda)
    spec = PlanSpec(backend=backend, schedule=schedule, fuse_remap=fuse,
                    rows_pp=4, block_p=8)
    state = make_engine((idx, val, dims), spec, start_mode=1, cache=False)
    before = kmt.LAUNCHES[name]
    outs, nxt = engine.all_modes(state, facs)
    torch.cuda.synchronize()
    assert kmt.LAUNCHES[name] == before + nmodes
    for d in range(nmodes):
        torch.testing.assert_close(
            outs[d], mttkrp_ref(ti, tv, facs, d, dims[d]), **TOL)
    for a in ("val", "idx", "alpha"):
        assert torch.equal(getattr(nxt, a), getattr(state, a))


@pytest.mark.gpu
def test_cp_als_cuda_fused_matches_torch_backend(cuda):
    idx, val, dims, rng = _coo(5, 3000, 1)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    init = [rng.random((d, 8)).astype(np.float32) for d in dims]
    fits = [cp_als(t, 8, iters=3, factors=init,
                   config=ExecutionConfig(backend=b)).fits
            for b in ("cuda_fused", "cuda", "torch")]
    assert all(np.isfinite(fits[0]))
    assert fits[0] == pytest.approx(fits[2], abs=1e-4)
    assert fits[1] == pytest.approx(fits[2], abs=1e-4)


def _wkv_args(bh, t, k, v, seed, device):
    g = torch.Generator().manual_seed(seed)
    r, kk, vv = (torch.randn(s, generator=g) for s in
                 ((bh, t, k), (bh, t, k), (bh, t, v)))
    w = 0.5 + 0.499 * torch.rand((bh, t, k), generator=g)
    u = torch.randn((bh, k), generator=g)
    return tuple(x.to(device) for x in (r, kk, w, vv, u))


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,k,v", [
    (2, 16, 8, 8), (4, 32, 16, 32), (1, 64, 64, 64), (160, 256, 64, 64),
    (3, 37, 32, 16), (1, 1, 64, 64), (161, 4097, 64, 64), (2, 40, 8, 64),
    (20, 4096, 64, 64)])
def test_wkv6_kernel_matches_plain(cuda, bh, t, k, v):
    """The shapes of the reference kernel tests, the model's rows at
    T = 256, T that are no multiple of the kernel's 16-step chunk (37,
    one step, the prefill's 4096 + 1), BH = 1 and 161 (no multiple of the
    132 SMs), K = 8 (two K slices) with V = 64 (four tiles), and a
    rwkv6-3b model shard's rows in a (data 2, model 2) training step (B
    1 times 20 of the 40 heads, T 4096)."""
    args = _wkv_args(bh, t, k, v, bh + t, cuda)
    before = kw6.LAUNCHES["wkv6"]
    got = kw6.wkv6(*args)
    want = kw6.wkv6_plain(*args)
    torch.cuda.synchronize()
    assert kw6.LAUNCHES["wkv6"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,k,v", [
    (4, 37, 64, 64), (2, 40, 8, 64), (3, 20, 16, 8)])
def test_wkv6_kernel_matches_its_twin(cuda, bh, t, k, v):
    """The kernel against ``wkv6_grouped`` at the kernel's own groups (8
    K slices at K >= 32, 4 at K = 16, 2 at K = 8)."""
    args = _wkv_args(bh, t, k, v, bh * t, cuda)
    got = kw6.wkv6(*args)
    want = kw6.wkv6_grouped(*args, kw6.kernel_groups(k))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_wkv6_refuses_what_it_does_not_take(cuda):
    before = kw6.LAUNCHES["wkv6"]
    with pytest.raises(ValueError, match="K and V in"):
        kw6.wkv6(*_wkv_args(2, 8, 12, 16, 0, cuda))
    with pytest.raises(ValueError, match="K and V in"):
        kw6.wkv6(*_wkv_args(2, 8, 16, 128, 0, cuda))
    assert kw6.LAUNCHES["wkv6"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t", [(2, 16), (3, 37), (1, 1), (40, 513),
                                  (161, 300), (2, 5), (3, 13), (2, 24),
                                  (133, 40), (80, 4096), (20, 4096)])
def test_wkv6_backward_kernel_matches_plain(cuda, bh, t):
    """``wkv6`` where autograd records: ``WKV6Fn`` launches the forward
    and the backward kernel once each; dr, dk, dw, dv, du against
    ``wkv6_backward_plain`` in float64 on the card. T shorter than the
    kernel's 8-step sub-chunk (1, 5) and than its 16-step chunk (13), a
    chunk and a half (24), no multiple of either (37, 300, 513); BH 1
    and 2 (one cluster of 4 CTAs a bh: no wave filled), 133 (532 CTAs,
    more than 4 a SM on 132 SMs) and 161; the training step's BH 80 at T
    4096, and a model shard's BH 20 of it on (data 2, model 2)."""
    args = _wkv_args(bh, t, 64, 64, bh + t, cuda)
    dy = torch.randn((bh, t, 64), generator=torch.Generator().manual_seed(
        t)).to(cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = dict(kw6.LAUNCHES)
    kw6.wkv6(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert kw6.LAUNCHES["wkv6"] == before["wkv6"] + 1
    assert kw6.LAUNCHES["wkv6_bwd"] == before["wkv6_bwd"] + 1
    want = kw6.wkv6_backward_plain(*(a.double() for a in (*args, dy)))
    for a, w in zip(leaves, want):
        torch.testing.assert_close(a.grad.double(), w, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t", [(3, 37), (80, 600)])
def test_wkv6_backward_kernel_repeats_bitwise(cuda, bh, t):
    """Every sum of the backward kernel is taken in a fixed order (no
    atomics; the cluster's dv partials in rank then warp order): two
    launches on the same inputs give the same bits."""
    args = _wkv_args(bh, t, 64, 64, 7 * bh + t, cuda)
    dy = torch.randn((bh, t, 64), generator=torch.Generator().manual_seed(
        bh)).to(cuda)
    first = [x.clone() for x in kw6.wkv6_backward(*args, dy)]
    second = kw6.wkv6_backward(*args, dy)
    torch.cuda.synchronize()
    for name, a, b in zip(("dr", "dk", "dw", "dv", "du"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_wkv6_backward_refuses_what_it_does_not_take(cuda):
    """The backward kernel takes K = V = 64 only: a forward that would need
    it elsewhere is refused before any launch, and so is the backward
    itself on a shape or device it does not take."""
    before = dict(kw6.LAUNCHES)
    r, k, w, v, u = _wkv_args(2, 8, 16, 16, 0, cuda)
    with pytest.raises(ValueError, match="K = V = 64"):
        kw6.wkv6(r.requires_grad_(), k, w, v, u)
    r, k, w, v, u = _wkv_args(2, 8, 64, 64, 0, cuda)
    dy = torch.zeros_like(v)
    with pytest.raises(ValueError, match="dy has shape"):
        kw6.wkv6_backward(r, k, w, v, u, dy[:, :4])
    with pytest.raises(ValueError, match="dy is on cpu"):
        kw6._launch_bwd(r, k, w, v, u, dy.cpu())
    assert kw6.LAUNCHES == before


@pytest.mark.gpu
def test_forward_launches_wkv6_once_per_layer(cuda):
    """float32 (TF32 off) ``forward`` on the card: one ``wkv6`` launch a
    layer, logits equal to the CPU's (plain recurrence) on the same
    weights."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer

    cfg = dataclasses.replace(smoke("rwkv6-3b"), compute_dtype="float32")
    model = transformer.init_model(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in model.layers:          # a non-zero, varying decay
        layer.wb_lora.copy_(0.15 * torch.randn(layer.wb_lora.shape,
                                               generator=g))
    tok = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    want = transformer.forward(model, cfg, tok)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = model.to(cuda)
        kw6.reset_launch_counts()
        got = transformer.forward(model, cfg, tok.to(cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert kw6.LAUNCHES["wkv6"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
def test_engine_on_the_card_by_default(cuda):
    """Model, cache and ``Engine`` on the default device (the card):
    ``Engine.prefill`` (the decode recurrence) agrees with ``forward``
    (the kernel) at the last position, float32."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer
    from repro_torch.serving import Engine, ServeConfig

    cfg = dataclasses.replace(smoke("rwkv6-3b"), compute_dtype="float32")
    model = transformer.init_model(cfg, 0)
    assert model.embed.is_cuda
    g = torch.Generator(device="cuda").manual_seed(1)
    for layer in model.layers:
        layer.wb_lora.normal_(0.0, 0.15, generator=g)
    tok = torch.randint(0, cfg.vocab, (2, 32), generator=g, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = transformer.forward(model, cfg, tok)[:, -1]
            got = Engine(model, cfg, ServeConfig(2, 64)).prefill(tok)[:, -1]
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def _lru_args(b, t, d, seed, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    a = 0.3 + 0.699 * torch.rand((b, t, d), generator=g)
    x = torch.randn((b, t, d), generator=g)
    return a.to(dtype).to(device), x.to(dtype).to(device)


LRU_SPLIT_SHAPES = [(2, 4096, 4096), (1, 32768, 1024), (1, 5000, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d", [
    (1, 32, 8), (2, 64, 128), (2, 33, 130), (3, 1000, 4100), (4, 256, 4096),
    (1, 4096, 2048)] + LRU_SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_lru_scan_kernel_matches_plain(cuda, b, t, d, dtype):
    """The reference kernel tests' shapes, T and D that are no multiple of
    the kernel's 16-step stage or 32-channel CTA, the model's rows at
    T = 256, a recurrentgemma-9b model shard's in a (data 2, model 2)
    training step (B 1, T 4096, 2048 of the 4096 channels: 32 spans), the
    single-device training step's (2, 4096, 4096), a long T whose spans do
    not fit the kernel's ring (1, 32768, 1024: 64 spans of 512, read
    twice) and spans that do not divide T (1, 5000, 1000); float16 inputs
    are cast to float32 first."""
    args = _lru_args(b, t, d, b + t + d, cuda, dtype)
    before = klru.LAUNCHES["lru_scan"]
    got = klru.lru_scan(*args)
    want = klru.lru_scan_plain(*args)
    torch.cuda.synchronize()
    assert klru.LAUNCHES["lru_scan"] == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_lru_scan_refuses_what_it_does_not_take(cuda):
    before = klru.LAUNCHES["lru_scan"]
    a, x = _lru_args(2, 8, 16, 0, cuda)
    with pytest.raises(ValueError, match="of one shape"):
        klru.lru_scan(a, x[:, :4])
    with pytest.raises(ValueError, match="B <= 65535"):
        klru.lru_scan(*_lru_args(65536, 1, 1, 0, cuda))
    with pytest.raises(ValueError, match="x is on cpu"):
        klru.lru_scan(a, x.cpu())
    assert klru.LAUNCHES["lru_scan"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d", [
    (1, 32, 8), (2, 33, 130), (3, 1000, 4100), (4, 256, 4096),
    (1, 4096, 2048)] + LRU_SPLIT_SHAPES)
def test_lru_scan_backward_kernel_matches_plain(cuda, b, t, d):
    """``lru_scan`` where autograd records: ``LRUScanFn`` launches the
    forward and the reverse-scan kernel once each; da and dx against
    ``lru_scan_backward_plain`` in float64 on the card (T and D no
    multiple of the 16-step stage or the 32-channel CTA included; a
    recurrentgemma-9b model shard's (1, 4096, 2048) on (data 2, model
    2), and the forward test's split shapes)."""
    a, x = _lru_args(b, t, d, b + t + d, cuda)
    dh = torch.randn((b, t, d), generator=torch.Generator().manual_seed(
        t)).to(cuda)
    la, lx = a.clone().requires_grad_(True), x.clone().requires_grad_(True)
    before = dict(klru.LAUNCHES)
    h = klru.lru_scan(la, lx)
    h.backward(dh)
    torch.cuda.synchronize()
    assert klru.LAUNCHES["lru_scan"] == before["lru_scan"] + 1
    assert klru.LAUNCHES["lru_scan_bwd"] == before["lru_scan_bwd"] + 1
    wa, wx = klru.lru_scan_backward_plain(a.double(), h.detach().double(),
                                          dh.double())
    torch.testing.assert_close(la.grad.double(), wa, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lx.grad.double(), wx, rtol=1e-5, atol=1e-5)


def _lru_limit(a, x):
    """``chip_smoke.py``'s per-element limit of a float32 scan against
    float64 (2 LAMBDA 2 sqrt(t + 1) u A_t, A the scan on |a|, |x|)."""
    big = klru.lru_scan_steps(a.double().abs(), x.double().abs())
    t = torch.arange(a.shape[1], device=a.device, dtype=torch.float64)
    return 8 * (t + 1).sqrt()[None, :, None] * 2.0 ** -24 * big


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d", [(1, 4096, 2048), (1, 32768, 1024),
                                   (1, 5000, 1000)])
def test_lru_scan_kernels_carry_across_spans(cuda, b, t, d):
    """a in [0.999, 1): a span's product P stays near 1, so every carry
    and its P reach the next spans (with a in [0.3, 1) P underflows and a
    wrong P would not show). Both kernels against the float64 plain
    versions within ``chip_smoke.py``'s limits, and a carry dropped at the
    first and at a middle split boundary fails them."""
    a, x = _lru_args(b, t, d, t, cuda)
    a = 0.999 + (a - 0.3) / 0.699 * 0.001
    bounds = klru.split_bounds(b, t, d, klru.device_sms(a.device))
    assert len(bounds) > 1
    want = klru.lru_scan_steps(a.double(), x.double())
    lim = _lru_limit(a, x)
    got = klru.lru_scan(a, x)
    assert ((got.double() - want).abs() <= lim).all()
    dh = torch.randn((b, t, d), generator=torch.Generator().manual_seed(
        t)).to(cuda)
    h = want.float()
    wda, wdx = klru.lru_scan_backward_plain(a.double(), want, dh.double())
    steps = t - torch.arange(t, device=cuda, dtype=torch.float64)
    scale = 2 * (2 * steps.sqrt() + 3)[None, :, None] * 2.0 ** -24
    lims = [scale * v for v in klru.lru_scan_backward_plain(
        a.double(), want.abs(), dh.double().abs())]
    da, dx = klru.lru_scan_backward(a, h, dh)
    for g, w, lm in ((da, wda, lims[0]), (dx, wdx, lims[1])):
        assert ((g.double() - w).abs() <= lm).all()
    for lo, _ in {bounds[1], bounds[len(bounds) // 2]}:
        bad = a.clone()
        bad[:, lo] = 0
        assert ((klru.lru_scan(bad, x).double() - want).abs() > lim).any()
        bda, bdx = klru.lru_scan_backward(bad, h, dh)
        assert ((bdx.double() - wdx).abs() > lims[1]).any()


@pytest.mark.gpu
def test_lru_scan_kernels_repeat_bitwise(cuda):
    """Two launches of each kernel at a shape of 32 spans give the same
    bits: the carries are folded in a fixed order, whatever order the CTAs
    run in."""
    a, x = _lru_args(1, 4096, 2048, 5, cuda)
    assert len(klru.split_bounds(1, 4096, 2048,
                                 klru.device_sms(a.device))) > 1
    h1, h2 = klru.lru_scan(a, x), klru.lru_scan(a, x)
    dh = torch.randn_like(a)
    g1, g2 = klru.lru_scan_backward(a, h1, dh), klru.lru_scan_backward(
        a, h1, dh)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2)
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])


@pytest.mark.gpu
def test_lru_scan_backward_refuses_what_it_does_not_take(cuda):
    before = dict(klru.LAUNCHES)
    a, x = _lru_args(2, 8, 16, 0, cuda)
    with pytest.raises(ValueError, match="of one shape"):
        klru.lru_scan_backward(a, x, x[:, :4])
    with pytest.raises(ValueError, match="dh is on cpu"):
        klru._launch_bwd(a, x, x.cpu())
    with pytest.raises(ValueError, match="B <= 65535"):
        klru._launch_bwd(*(_lru_args(65536, 1, 1, 0, cuda)[0],) * 3)
    assert klru.LAUNCHES == before


@pytest.mark.gpu
def test_forward_launches_lru_scan_once_per_rec_layer(cuda):
    """float32 (TF32 off) ``forward`` of recurrentgemma at smoke width and
    the full config's depth, 38 layers of (rec, rec, local): one
    ``lru_scan`` launch a rec layer (26), logits equal to the CPU's
    (plain recurrence) on the same weights; S 64 > window 16."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer

    cfg = dataclasses.replace(smoke("recurrentgemma-9b"), n_layers=38,
                              compute_dtype="float32")
    n_rec = transformer.layer_kinds(cfg).count("rec")
    assert n_rec == 26
    model = transformer.init_model(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = transformer.forward(model, cfg, tok)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = model.to(cuda)
        klru.reset_launch_counts()
        with torch.no_grad():
            got = transformer.forward(model, cfg, tok.to(cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert klru.LAUNCHES["lru_scan"] == n_rec
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_recurrentgemma_engine_on_the_card_by_default(cuda):
    """Model, cache and ``Engine`` on the default device (the card):
    ``Engine.prefill`` (the decode recurrence, the ring buffer wrapping
    past window 16) agrees with ``forward`` (the kernel) at the last
    position, float32."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer
    from repro_torch.serving import Engine, ServeConfig

    cfg = dataclasses.replace(smoke("recurrentgemma-9b"),
                              compute_dtype="float32")
    model = transformer.init_model(cfg, 0)
    assert model.embed.is_cuda
    tok = torch.randint(0, cfg.vocab, (2, 40), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = transformer.forward(model, cfg, tok)[:, -1]
            got = Engine(model, cfg, ServeConfig(2, 64)).prefill(tok)[:, -1]
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# The streaming tier on the card (chip_smoke.py [12a] at a small size).
# --------------------------------------------------------------------------
def _stream_case(cuda, nmodes=3, schedule="compact"):
    idx, val, dims, rng = _coo(nmodes, 2000, nmodes + 11)
    t = build_flycoo(idx, val, dims, rows_pp=4, block_p=8,
                     schedule=schedule)
    facs = [torch.from_numpy(rng.standard_normal((d, 32))
                             .astype(np.float32)).to(cuda) for d in dims]
    return t, facs


@pytest.mark.gpu
@pytest.mark.parametrize("backend,schedule,name", [
    ("cuda_fused", "compact", "mttkrp_fused_gather_compact"),
    ("cuda", "compact", "mttkrp_fused_compact"),
    ("cuda_fused", "rect", "mttkrp_fused_gather"),
    ("cuda", "rect", "mttkrp_fused")])
@pytest.mark.parametrize("nmodes", [3, 5])
def test_stream_matches_resident_on_the_card(cuda, backend, schedule, name,
                                             nmodes):
    """Each mode's streamed output within the tolerance of the resident
    engine's and the oracle's, the streamed host layout bitwise the
    resident one's first S_d slots after every mode, one kernel launch a
    chunk, every upload but each mode's first issued ahead."""
    from repro_torch.engine.stream import stream_init, stream_mttkrp

    t, facs = _stream_case(cuda, nmodes, schedule)
    cfg = ExecutionConfig(backend=backend, schedule=schedule, chunk_nnz=64)
    ti = torch.from_numpy(t.indices).to(cuda)
    tv = torch.from_numpy(t.values).to(cuda)
    st = engine.init(t, cfg)
    ss = stream_init(t, cfg)
    assert all(cs.nchunks > 1 for cs in ss.plan.chunks)
    for _ in range(nmodes):
        d = st.mode
        lay = mode_layout(st, (st.val, st.idx, st.alpha), d)
        sd = st.statics[d].padded_nnz
        for k in ("val", "idx", "alpha", "lrow"):
            assert np.array_equal(getattr(ss, k), lay[k][:sd].cpu().numpy())
        out_r, st = engine.mttkrp(st, facs)
        before = kmt.LAUNCHES[name]
        out_s, ss = stream_mttkrp(ss, facs)
        torch.cuda.synchronize()
        assert kmt.LAUNCHES[name] == before + ss.plan.chunks[d].nchunks
        torch.testing.assert_close(out_s, out_r, **TOL)
        torch.testing.assert_close(out_s, mttkrp_ref(ti, tv, facs, d,
                                                     t.dims[d]), **TOL)
    assert ss.stats.overlap_efficiency == pytest.approx(
        1 - nmodes / ss.stats.uploads)


@pytest.mark.gpu
def test_stream_waits_once_a_mode_and_reads_nothing_back(cuda, monkeypatch):
    """On the card the rotation's only host waits are one event a mode
    (before the host writes the layout that fed the uploads before): no
    ``.cpu()``, ``.item()`` or device ``synchronize``."""
    from repro_torch.engine.stream import stream_all_modes, stream_init

    t, facs = _stream_case(cuda)
    ss = stream_init(t, ExecutionConfig(backend="cuda_fused",
                                        chunk_nnz=64))
    stream_all_modes(ss, facs)          # a warm-up rotation
    calls = []

    def counting(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    for owner, name in ((torch.cuda, "device"), (torch.cuda.Stream, "stream"),
                        (torch.cuda.Event, "event")):
        monkeypatch.setattr(owner, "synchronize",
                            counting(name, owner.synchronize))
    _, ss = stream_all_modes(ss, facs)
    monkeypatch.undo()
    assert calls == ["event"] * t.nmodes


@pytest.mark.gpu
def test_cp_als_stream_on_the_card(cuda):
    from repro_torch.engine.stream import cp_als_stream

    t, facs = _stream_case(cuda, nmodes=5)
    init = [f[:, :8].contiguous() for f in facs]
    cfg = ExecutionConfig(backend="cuda_fused", chunk_nnz=64)
    a = cp_als_stream(t, 8, iters=3, config=cfg, factors=init).fits
    b = cp_als(t, 8, iters=3, config=cfg, factors=init).fits
    assert all(np.isfinite(a))
    assert a == pytest.approx(b, abs=1e-4)


@pytest.mark.gpu
def test_stream_timeline_and_peak(cuda):
    """With ``stats.timeline`` a list, each upload and each chunk's
    compute leave a pair of timing events; ``as_row`` reads the device
    peak."""
    from repro_torch.engine.stream import stream_all_modes, stream_init

    t, facs = _stream_case(cuda)
    ss = stream_init(t, ExecutionConfig(backend="cuda_fused",
                                        chunk_nnz=64))
    ss.stats.timeline = []
    _, ss = stream_all_modes(ss, facs)
    torch.cuda.synchronize()
    kinds = [e[0] for e in ss.stats.timeline]
    assert kinds.count("upload") == kinds.count("compute") == \
        ss.plan.total_chunks
    assert all(a.elapsed_time(b) >= 0 for _, _, _, a, b in
               ss.stats.timeline)
    assert ss.stats.as_row()["device_peak_bytes"] > 0


# --------------------------------------------------------------------------
# Resilience on the card (chip_smoke.py [13] at a small size).
# --------------------------------------------------------------------------
@pytest.fixture
def no_chaos():
    from repro_torch.resilience import uninstall

    uninstall()
    yield
    uninstall()


@pytest.mark.gpu
def test_classify_a_real_cuda_oom(cuda):
    from repro_torch.resilience import classify

    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(1 << 46, dtype=torch.uint8, device=cuda)
    assert classify(ei.value) == "oom"


@pytest.mark.gpu
def test_compile_rung_on_the_card(cuda, no_chaos):
    """An injected build failure of ``cuda_fused`` steps ``cp_als`` down
    to ``cuda``: the pre-gathered kernel launches from then on, the
    balanced pair no more, and the fits are ``cuda``'s own."""
    from repro_torch.resilience import ChaosSpec, install

    idx, val, dims, rng = _coo(4, 3000, 5)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    init = [rng.random((d, 8)).astype(np.float32) for d in dims]
    want = cp_als(t, 8, iters=3, factors=init,
                  config=ExecutionConfig(backend="cuda")).fits
    install(ChaosSpec(compile_fail=("cuda_fused",)))
    fused = kmt.LAUNCHES["mttkrp_fused_remap_compact"]
    pre = kmt.LAUNCHES["mttkrp_fused_compact"]
    got = cp_als(t, 8, iters=3, factors=init, ladder=True,
                 config=ExecutionConfig(backend="cuda_fused")).fits
    torch.cuda.synchronize()
    assert kmt.LAUNCHES["mttkrp_fused_remap_compact"] == fused
    assert kmt.LAUNCHES["mttkrp_fused_compact"] == pre + 3 * len(dims)
    assert got == pytest.approx(want, abs=1e-4)


@pytest.mark.gpu
def test_no_plain_rung_on_the_card(cuda, no_chaos):
    """Under a ladder, a build failure of ``cuda`` (the last hand-written
    backend) raises on the card, in ``cp_als`` and in the stream: no rung
    hands the card's tensors to plain PyTorch."""
    from repro_torch.engine.stream import stream_all_modes, stream_init
    from repro_torch.resilience import (DEFAULT_POLICY, ChaosCompileError,
                                        ChaosSpec, install)

    idx, val, dims, rng = _coo(3, 3000, 5)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    install(ChaosSpec(compile_fail=("cuda_fused", "cuda")))
    with pytest.raises(ChaosCompileError):
        cp_als(t, 8, iters=2, ladder=True,
               config=ExecutionConfig(backend="cuda_fused"))
    facs = [torch.from_numpy(rng.random((d, 8)).astype(np.float32))
            .to(cuda) for d in dims]
    install(ChaosSpec(compile_fail=("cuda",)))
    with pytest.raises(ChaosCompileError):
        stream_all_modes(stream_init(t, ExecutionConfig(
            backend="cuda", block_p=16, chunk_nnz=256)), facs,
            policy=DEFAULT_POLICY)


@pytest.mark.gpu
def test_stream_rungs_on_the_card(cuda, no_chaos):
    """The chunk-budget halving and the upload retry on the card: each
    mode within the tolerance of a clean stream."""
    from repro_torch.engine.stream import stream_all_modes, stream_init
    from repro_torch.resilience import ChaosSpec, LadderPolicy, install

    t, facs = _stream_case(cuda)
    # block_p as the tensor's, so that the 64-slot budget can halve
    cfg = ExecutionConfig(backend="cuda_fused", block_p=8, chunk_nnz=64)
    want, _ = stream_all_modes(stream_init(t, cfg), facs)
    policy = LadderPolicy(backoff_base_s=1e-4, backoff_cap_s=1e-3)
    for spec, field in ((ChaosSpec(oom_chunk=3), "budget_halvings"),
                        (ChaosSpec(upload_fail=1, upload_fail_times=2),
                         "upload_retries")):
        install(spec)
        got, ss = stream_all_modes(stream_init(t, cfg), facs, policy=policy)
        torch.cuda.synchronize()
        assert getattr(ss.stats, field) == (1 if field[0] == "b" else 2)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.gpu
def test_cp_als_resume_on_the_card(cuda, tmp_path, no_chaos):
    idx, val, dims, rng = _coo(3, 3000, 2)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    init = [rng.random((d, 8)).astype(np.float32) for d in dims]
    cfg = ExecutionConfig(backend="cuda_fused")
    full = cp_als(t, 8, iters=4, factors=init, config=cfg).fits
    cp_als(t, 8, iters=2, factors=init, config=cfg, checkpoint=tmp_path)
    got = cp_als(t, 8, iters=4, factors=init, config=cfg,
                 checkpoint=tmp_path, resume=True).fits
    assert got[:2] == pytest.approx(full[:2], abs=1e-4)
    assert got == pytest.approx(full, abs=1e-4)


# --------------------------------------------------------------------------
# The distributed tier on the card (chip_smoke.py [14] at a small size):
# shards on one card, or on as many as there are.
# --------------------------------------------------------------------------
def _dist_mesh(cuda, n):
    from repro_torch.launch.mesh import make_mesh

    have = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if have >= n
            else [cuda] * n)
    return make_mesh((n,), ("data",), devices=devs)


def _dist_case(cuda, nmodes=3, schedule="compact", seed=21):
    from repro_torch.core import build_sharded_flycoo

    idx, val, dims, rng = _coo(nmodes, 3000, seed)
    t = build_sharded_flycoo(idx, val, dims, n_dev=4, rows_pp=4, block_p=8,
                             schedule=schedule)
    facs = [torch.from_numpy(rng.standard_normal((d, 32))
                             .astype(np.float32)).to(cuda) for d in dims]
    return t, facs


@pytest.mark.gpu
@pytest.mark.parametrize("backend,schedule,name", [
    ("cuda_fused", "compact", "mttkrp_fused_gather_compact"),
    ("cuda", "compact", "mttkrp_fused_compact"),
    ("cuda_fused", "rect", "mttkrp_fused_gather"),
    ("cuda", "rect", "mttkrp_fused")])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_dist_matches_single_device_on_the_card(cuda, backend, schedule,
                                                name, n_dev):
    """Each mode on every shard's work table: one launch a shard a mode,
    each mode within the tolerance of the single-device engine and the
    oracle, the layout after each transition bitwise the one ``shard_state``
    gives of the single-device engine's next layout, under both
    exchanges."""
    from repro_torch.engine import DistConfig, dist

    t, facs = _dist_case(cuda, 3, schedule)
    cfg = ExecutionConfig(backend=backend, schedule=schedule)
    ti = torch.from_numpy(t.indices).to(cuda)
    tv = torch.from_numpy(t.values).to(cuda)
    for exchange in dist.EXCHANGES:
        st = engine.init(t, cfg)
        ds = dist.shard_state(st, _dist_mesh(cuda, n_dev),
                              DistConfig(exchange=exchange))
        for _ in range(3):
            d = ds.mode
            before = kmt.LAUNCHES[name]
            out, ds = dist.dist_mttkrp(ds, facs)
            assert kmt.LAUNCHES[name] == before + n_dev
            want, st = engine.mttkrp(st, facs)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, **TOL)
            torch.testing.assert_close(
                out, mttkrp_ref(ti, tv, facs, d, t.dims[d]), **TOL)
            nxt = dist.shard_state(st, ds.mesh, ds.dist)
            for a, b in zip(ds.host_layout(), nxt.host_layout()):
                assert np.array_equal(a, b)


@pytest.mark.gpu
def test_dist_rotation_reads_nothing_back_on_the_card(cuda, monkeypatch):
    from repro_torch.engine import dist

    t, facs = _dist_case(cuda, 4)
    ds = dist.shard_state(engine.init(t, ExecutionConfig(
        backend="cuda_fused")), _dist_mesh(cuda, 4))
    dist.dist_all_modes(ds, facs)       # a warm-up rotation
    calls = []

    def counting(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counting("synchronize", torch.cuda.synchronize))
    dist.dist_all_modes(ds, facs)
    assert calls == []


@pytest.mark.gpu
def test_dist_cp_als_and_rungs_on_the_card(cuda, no_chaos):
    """``cp_als`` over 4 shards against the single-device run, and the
    exchange and device-loss rungs against the clean 4-shard run: fits
    within 1e-4."""
    from repro_torch.resilience import ChaosSpec, LadderPolicy, install

    t, _ = _dist_case(cuda, 3)
    rng = np.random.default_rng(4)
    init = [rng.random((d, 8)).astype(np.float32) for d in t.dims]
    cfg = ExecutionConfig(backend="cuda_fused")
    one = cp_als(t, 8, iters=3, factors=init, config=cfg).fits
    mesh = _dist_mesh(cuda, 4)
    clean = cp_als(t, 8, iters=3, factors=init, config=cfg, mesh=mesh).fits
    assert clean == pytest.approx(one, abs=1e-4)
    policy = LadderPolicy(backoff_base_s=1e-4, backoff_cap_s=1e-3)
    for spec in (ChaosSpec(exchange_fail=1),
                 ChaosSpec(device_lost=1, device_lost_n=2)):
        install(spec)
        got = cp_als(t, 8, iters=3, factors=init, config=cfg, mesh=mesh,
                     ladder=policy).fits
        assert got == pytest.approx(clean, abs=1e-4)


# --------------------------------------------------------------------------
# The CPD-factorized embedding and the dense attention family on the card.
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("vocab,d,rank,hot", [
    (512, 128, 16, False), (512, 128, 16, True), (32000, 256, 64, False)])
def test_cpd_embed_and_its_backward_on_the_card(cuda, vocab, d, rank, hot):
    """``cpd_embed``, its three gradients (``index_add_`` on the card:
    atomics, another sum order) and ``cpd_logits`` on the card against
    the CPU from the same factors, float32 with TF32 off."""
    from repro_torch.tensorized import (cpd_embed, cpd_logits,
                                        init_cpd_embedding)

    params = init_cpd_embedding(vocab, d, rank,
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(vocab + hot)
    ids = rng.choice(rng.integers(0, vocab, 5), (4, 64)) if hot else \
        rng.integers(0, vocab, (4, 64))
    tok = torch.from_numpy(ids)
    g = torch.from_numpy(rng.standard_normal((4, 64, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 8, d)).astype(np.float32))

    def run(dev):
        leaves = {k: v.to(dev, copy=True).requires_grad_(True)
                  for k, v in params.items()}
        out = cpd_embed(leaves, tok.to(dev))
        out.backward(g.to(dev))
        with torch.no_grad():
            logits = cpd_logits(leaves, x.to(dev))
        return [t.cpu() for t in (out, leaves["A"].grad, leaves["B"].grad,
                                  leaves["C"].grad, logits)]

    want = run("cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = run(cuda)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cpd", [
    ("tinyllama-1.1b", False), ("olmo-1b", False), ("qwen2.5-3b", False),
    ("tinyllama-1.1b", True)])
def test_dense_forward_on_the_card_matches_the_cpu(cuda, arch, cpd):
    """float32 (TF32 off) ``forward`` of a dense smoke config (with the
    CPD embedding for tinyllama) on the card against the CPU on the same
    weights, at S 1024 (two query chunks, the causal mask across them)."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32",
                              cpd_embedding=cpd, cpd_rank=16 if cpd else 0)
    model = transformer.init_model(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 1024),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = transformer.forward(model, cfg, tok)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = model.to(cuda)
        with torch.no_grad():
            got = transformer.forward(model, cfg, tok.to(cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cpd_tinyllama_engine_on_the_card_by_default(cuda):
    """A CPD tinyllama (smoke width) on the default device: ``Engine``
    reads its device from the factors, ``Engine.prefill`` through the
    causal KV cache agrees with ``forward`` at the last position, and a
    request past the cache is refused before any work."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer
    from repro_torch.serving import Engine, ServeConfig

    cfg = dataclasses.replace(smoke("tinyllama-1.1b"), compute_dtype="float32",
                              cpd_embedding=True, cpd_rank=16)
    model = transformer.init_model(cfg, 0)
    assert model.embed_cpd.A.is_cuda
    tok = torch.randint(0, cfg.vocab, (2, 40), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = transformer.forward(model, cfg, tok)[:, -1]
            eng = Engine(model, cfg, ServeConfig(2, 48))
            got = eng.prefill(tok)[:, -1]
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="max_len 48"):
        eng.generate(tok[:, :1], 8)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "tinyllama-1.1b", "olmoe-1b-7b"])
def test_train_step_on_the_card(cuda, arch):
    """One float32 (TF32 off) train step of a smoke config on the card
    against the same step on the CPU from the same state: the backward
    kernels launch once a recurrent layer, the forward kernels twice
    (``remat="full"``: the forward, then its recompute); losses rtol
    1e-4, updated parameters within 2 lr (Adam's first step flips where
    a gradient is float32 noise around 0) and within 1e-5 where the
    gradient is >= 1e-4."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32",
                              remat="full")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cpu = init_state(cfg, ocfg, 0, device="cpu")
    card = init_state(cfg, ocfg, 0, device="cuda")
    for a, b in zip(leaves(card["params"]), leaves(cpu["params"])):
        a.copy_(b)
    batch = SyntheticLM(cfg, 2, 64, device="cpu").next()
    kinds = transformer.layer_kinds(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw6.reset_launch_counts()
        klru.reset_launch_counts()
        got, gm = make_train_step(cfg, ocfg)(
            card, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert kw6.LAUNCHES == {"wkv6": 2 * kinds.count("rwkv"),
                            "wkv6_bwd": kinds.count("rwkv")}
    assert klru.LAUNCHES == {"lru_scan": 2 * kinds.count("rec"),
                             "lru_scan_bwd": kinds.count("rec")}
    want, wm = make_train_step(cfg, ocfg)(cpu, batch)
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-4)
    for a, b, m in zip(leaves(got["params"]), leaves(want["params"]),
                       leaves(want["opt"]["m"])):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2e-3
        assert float(torch.where(m.abs() >= 1e-5, d, 0).max()) <= 1e-5


# --------------------------------------------------------------------------
# Sharded training on the card (shards of cuda:0, a single controller)
# --------------------------------------------------------------------------
def _card_ctx(shape):
    import math

    from repro_torch import sharding
    from repro_torch.launch.mesh import make_mesh

    axes = ("data", "model")[:len(shape)]
    return sharding.make_ctx(make_mesh(shape, axes,
                                       ["cuda:0"] * math.prod(shape)))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", (2, 2)),
                                        ("qwen2.5-3b", (1, 4)),
                                        ("rwkv6-3b", (2, 1)),
                                        ("recurrentgemma-9b", (2, 1)),
                                        ("rwkv6-3b", (2, 2)),
                                        ("recurrentgemma-9b", (2, 2))])
def test_sharded_train_step_on_the_card(cuda, arch, shape):
    """One float32 (TF32 off) sharded step of a smoke config over shards
    of ``cuda:0`` against the single-device step on the card from the
    same state: losses rtol 1e-5, every gradient (the first moment)
    rtol 1e-4 / atol 1e-7, parameters within 1e-6 wherever |g| >= 1e-6
    and within 2 lr elsewhere (the first Adam step is sign-like where g
    is float32 noise); the recurrence kernels launch on each shard
    (forward, recompute, backward): over (data 2, model 2) on a model
    shard's heads or channels."""
    import dataclasses
    import math

    from repro_torch import sharding
    from repro_torch.configs import smoke
    from repro_torch.launch import specs
    from repro_torch.models import transformer
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32",
                              remat="full")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ctx = _card_ctx(shape)
    one = init_state(cfg, ocfg, 0, device="cuda")
    two = specs.place_state(one, ctx)
    batch = SyntheticLM(cfg, 4, 64, device="cuda").next()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, m1 = make_train_step(cfg, ocfg)(one, dict(batch))
        with sharding.use(ctx):
            step = make_train_step(cfg, ocfg)
        kw6.reset_launch_counts()
        klru.reset_launch_counts()
        two, m2 = step(two, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    kinds = transformer.layer_kinds(cfg)
    n = math.prod(shape)
    assert kw6.LAUNCHES == {"wkv6": 2 * n * kinds.count("rwkv"),
                            "wkv6_bwd": n * kinds.count("rwkv")}
    assert klru.LAUNCHES == {"lru_scan": 2 * n * kinds.count("rec"),
                             "lru_scan_bwd": n * kinds.count("rec")}
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    got = sharding.gather(two)
    for a, b in zip(leaves(got["opt"]["m"]), leaves(one["opt"]["m"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    for a, b, m in zip(leaves(got["params"]), leaves(one["params"]),
                       leaves(one["opt"]["m"])):
        d = (a - b).abs()
        assert float(d.max()) <= 2e-3
        assert float(torch.where(m.abs() >= 1e-7, d, 0).max()) <= 1e-6


@pytest.mark.gpu
def test_sharded_reshard_on_the_card(cuda, tmp_path):
    """A state placed on (2, 2) shards of the card, saved, restored onto
    (2, 1): bitwise; the blob is the unsharded save's."""
    import os

    from repro_torch import sharding
    from repro_torch.configs import smoke
    from repro_torch.launch import specs
    from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                      init_state)
    from repro_torch.training.tree import leaves

    cfg = smoke("olmo-1b")
    ocfg = OptimizerConfig()
    plain = init_state(cfg, ocfg, 0, device="cuda")
    ctx4, ctx2 = _card_ctx((2, 2)), _card_ctx((2, 1))
    mgr = CheckpointManager(str(tmp_path / "a"), async_save=False)
    mgr.save(specs.place_state(plain, ctx4), {"step": 0})
    CheckpointManager(str(tmp_path / "b"), async_save=False).save(
        plain, {"step": 0})
    assert os.listdir(tmp_path / "a") == os.listdir(tmp_path / "b")
    with sharding.use(ctx2):
        back, _ = mgr.restore_latest(
            like=plain, shardings=specs.state_shardings(plain, ctx2))
    for a, b in zip(leaves(sharding.gather(back)), leaves(plain)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_pipeline_and_compression_on_the_card(cuda):
    """``pipeline_apply`` over 4 stages of ``cuda:0`` against the
    sequential stages (1e-5); ``compressed_grad_sync`` over 4 pods: the
    same on every pod, the error feedback the residual, a full-rank sync
    the mean (1e-4)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.compression import compressed_grad_sync
    from repro_torch.training.pipeline import pipeline_apply

    g = torch.Generator(device="cuda").manual_seed(0)
    ws = torch.randn(4, 64, 64, device="cuda", generator=g) / 8
    x = torch.randn(16, 64, device="cuda", generator=g)
    want = x
    for s in range(4):
        want = torch.tanh(want @ ws[s])
    mesh = make_mesh((4,), ("pp",), ["cuda:0"] * 4)
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh=mesh,
                       n_micro=4)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    grads = [{"w": torch.randn(128, 64, device="cuda", generator=g)}
             for _ in range(4)]
    synced, err = compressed_grad_sync(
        grads, 8, generator=torch.Generator(device="cuda").manual_seed(1))
    for k in range(4):
        assert torch.equal(synced[k]["w"], synced[0]["w"])
        torch.testing.assert_close(err[k]["w"], grads[k]["w"]
                                   - synced[k]["w"], rtol=0, atol=1e-5)
    full, _ = compressed_grad_sync(
        grads, 64, generator=torch.Generator(device="cuda").manual_seed(1))
    torch.testing.assert_close(full[0]["w"],
                               sum(gr["w"] for gr in grads) / 4,
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# The MoE family on the card (no port kernel: routing, dispatch, combine
# and the batched products are PyTorch ops, as the reference's are jnp)
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_moe_layer_at_full_width_on_the_card(cuda, arch):
    """One MoE layer at the full width of ``arch`` (olmoe: d 2048, 64
    experts of d_ff 1024, top-8; qwen3: d 4096, 128 of 1536), 256 tokens,
    float32 (TF32 off), its weights drawn on the card and copied to the
    CPU: routing ids equal wherever the CPU's k-th and (k+1)-th
    probabilities stand more than 1e-5 apart (a closer pair may flip
    under float32 rounding), weights rtol = atol = 1e-5; then, from the
    card's ids on both sides, the dispatch tables bitwise, the experts'
    outputs and the combine rtol = atol = 1e-4 of the largest output;
    the bf16 layer finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import Node

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    p = moe.init_moe(cfg, torch.Generator(device="cuda").manual_seed(0))
    pc = {k: v.cpu() for k, v in p.items()}
    xt = torch.randn(256, cfg.d_model, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(1))
    k, e = cfg.top_k, cfg.n_experts
    cap = moe._capacity(256, k, e, cfg.capacity_factor)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        w, ids = moe._route(xt, p["router"], k)
        buf, info = moe._dispatch(xt, ids, e, cap)
        out_buf = moe._expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"],
                                  cfg)
        y = moe._combine(out_buf, info, w, 256)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    xc = xt.cpu()
    wc, idc = moe._route(xc, pc["router"], k)
    probs = torch.softmax(xc @ pc["router"], -1).sort(-1, descending=True)[0]
    clear = (probs[:, k - 1] - probs[:, k]) > 1e-5
    assert int(clear.sum()) >= 250
    assert torch.equal(ids.cpu()[clear], idc[clear])
    torch.testing.assert_close(w.cpu()[clear], wc[clear], rtol=1e-5,
                               atol=1e-5)
    bufc, infoc = moe._dispatch(xc, ids.cpu(), e, cap)
    assert torch.equal(buf.cpu(), bufc)
    for a, b in zip(info, infoc):
        assert torch.equal(a.cpu(), b)
    outc = moe._expert_ffn(bufc, pc["w_gate"], pc["w_up"], pc["w_down"], cfg)
    top = float(outc.abs().max())
    torch.testing.assert_close(out_buf.cpu(), outc, rtol=1e-4,
                               atol=1e-4 * top)
    yc = moe._combine(out_buf.cpu(), infoc, w.cpu(), 256)
    torch.testing.assert_close(y.cpu(), yc, rtol=1e-4,
                               atol=1e-4 * float(yc.abs().max()))
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    y16 = moe._apply_local(Node(p), xt.view(4, 64, -1).bfloat16(), cfg16)
    assert y16.dtype == torch.bfloat16 and bool(torch.isfinite(y16).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_layer_repeats_bitwise_on_the_card(cuda, dtype):
    """One MoE layer at olmoe's full width on 4096 tokens (C 640 at the
    default capacity: pairs dropped), run twice on the same input: the
    outputs equal bit for bit (the combine adds each token's terms in a
    fixed order, with no atomics)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import Node

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                              compute_dtype=dtype)
    p = Node(moe.init_moe(cfg,
                          torch.Generator(device="cuda").manual_seed(0)))
    x = torch.randn(4, 1024, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    x = x.to(cfg.cdtype)
    with torch.no_grad():
        a = moe.apply_moe(p, x, cfg)
        b = moe.apply_moe(p, x, cfg)
    assert a.dtype == cfg.cdtype and bool(torch.isfinite(a).all())
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_moe_forward_and_engine_on_the_card(cuda, arch):
    """float32 (TF32 off) ``forward`` of a MoE smoke config on the card
    against the CPU on the same weights at B 2, S 64 (rtol = atol =
    1e-4), and at a capacity factor of 16 (nothing drops) the decode
    path through ``Engine.prefill`` against ``forward``'s last position
    on the card."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer
    from repro_torch.serving import Engine, ServeConfig

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32")
    model = transformer.init_model(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = transformer.forward(model, cfg, tok)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = model.to(cuda)
        with torch.no_grad():
            got = transformer.forward(model, cfg, tok.to(cuda))
            cf16 = dataclasses.replace(cfg, capacity_factor=16.0)
            last = transformer.forward(model, cf16, tok.to(cuda))[:, -1]
            pre = Engine(model, cf16, ServeConfig(2, 64)).prefill(
                tok.to(cuda))[:, -1]
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pre, last, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_moe_step_on_the_card(cuda, shape):
    """One float32 (TF32 off) sharded step of the smoke olmoe, its 8
    experts over the model axis of shards of ``cuda:0``, at a capacity
    factor of E / k = 4 (nothing drops on either side), against the
    single-device step on the card from the same state: as
    ``test_sharded_train_step_on_the_card``."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.configs import smoke
    from repro_torch.launch import specs
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves

    cfg = dataclasses.replace(smoke("olmoe-1b-7b"), compute_dtype="float32",
                              remat="full", capacity_factor=4.0)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ctx = _card_ctx(shape)
    one = init_state(cfg, ocfg, 0, device="cuda")
    two = specs.place_state(one, ctx)
    batch = SyntheticLM(cfg, 4, 64, device="cuda").next()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, m1 = make_train_step(cfg, ocfg)(one, dict(batch))
        with sharding.use(ctx):
            two, m2 = make_train_step(cfg, ocfg)(two, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    got = sharding.gather(two)
    for a, b in zip(leaves(got["opt"]["m"]), leaves(one["opt"]["m"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    for a, b, m in zip(leaves(got["params"]), leaves(one["params"]),
                       leaves(one["opt"]["m"])):
        d = (a - b).abs()
        assert float(d.max()) <= 2e-3
        assert float(torch.where(m.abs() >= 1e-7, d, 0).max()) <= 1e-6


# --------------------------------------------------------------------------
# The other families (command-r, paligemma, whisper) and the int8 KV cache
# --------------------------------------------------------------------------
FAMILIES = ("command-r-plus-104b", "paligemma-3b", "whisper-large-v3")


def _family_inputs(cfg, b, seed):
    """A smoke config's extra model inputs (float32, on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.kind == "vlm":
        return {"embeds": torch.randn((b, cfg.n_img_tokens, cfg.d_model),
                                      generator=gen)}
    if cfg.kind == "audio":
        return {"enc_embeds": torch.randn((b, 48, cfg.d_model),
                                          generator=gen)}
    return {}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_and_engine_on_the_card(cuda, arch):
    """float32 (TF32 off) ``forward`` of a smoke config on the card
    against the CPU on the same weights (paligemma's 4 image embeddings
    prepended, whisper's 48 frames encoded) at B 2, S 64, rtol = atol =
    1e-4; the decode path (``Engine.prefill``; whisper's engine builds
    its cross caches from the same frames) against ``forward``'s last
    position on the card. paligemma decodes causally, as the reference
    does: its engine is held to the copy without image tokens."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer
    from repro_torch.serving import Engine, ServeConfig

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32")
    model = transformer.init_model(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    kw = _family_inputs(cfg, 2, 2)
    with torch.no_grad():
        want = transformer.forward(model, cfg, tok, **kw)
    ecfg = dataclasses.replace(cfg, n_img_tokens=0)
    enc = kw.get("enc_embeds")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = model.to(cuda)
        ckw = {k: v.to(cuda) for k, v in kw.items()}
        with torch.no_grad():
            got = transformer.forward(model, cfg, tok.to(cuda), **ckw)
            last = transformer.forward(
                model, ecfg, tok.to(cuda),
                enc_embeds=ckw.get("enc_embeds"))[:, -1]
            pre = Engine(model, ecfg, ServeConfig(2, 64),
                         enc_embeds=None if enc is None else enc.to(cuda)
                         ).prefill(tok.to(cuda))[:, -1]
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pre, last, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_kv_quant_decode_on_the_card(cuda, arch):
    """16 float32 decode steps (TF32 off) of a 1-layer copy of a smoke
    config with ``kv_quant`` on the card and on the CPU from the same
    weights, in lockstep. One decoder layer: the row a step writes
    depends only on its token (and whisper's encoder output, which the
    cross cache keeps in float), so the two sides' float32 rows differ
    by ~1e-7 at every step and a difference never carries into later
    rows. Every int8 row is within one step of the CPU's and at most 1%
    of them are off (a row element whose x / s lies within float32
    rounding, ~1e-5, of a half-integer rounds to either side); the
    scales rtol 1e-5. While the two int8 caches are equal, the step's
    logits rtol = atol = 1e-4; from the first flip on, atol 1e-2: a
    flipped element moves one cached value by one step, s (1/127 of
    its row's largest), which moves an attention logit by ~s |q_i| /
    sqrt(hd) and the logits by ~1e-3 at these widths (9.2e-4 was seen
    on an H100)."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.models import transformer

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32",
                              kv_quant=True, n_layers=1)
    model = transformer.init_model(cfg, 0, device="cpu")
    card = transformer.init_model(cfg, 0, device="cpu").to(cuda)
    kw = _family_inputs(cfg, 2, 3)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(4))
    enc_len = 48 if cfg.n_enc_layers else 0

    def start(m, dev):
        cache = transformer.init_cache(cfg, 2, 16, device=dev,
                                       enc_len=enc_len)
        if cfg.n_enc_layers:
            cache = transformer.build_cross_caches(
                m, cfg, kw["enc_embeds"].to(dev), cache)
        return cache

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    flipped, off, n = False, 0, 0
    try:
        with torch.no_grad():
            wc, gc = start(model, "cpu"), start(card, cuda)
            for t in range(16):
                want, wc = transformer.decode_step(model, wc, cfg,
                                                   toks[:, t:t + 1])
                got, gc = transformer.decode_step(
                    card, gc, cfg, toks[:, t:t + 1].to(cuda))
                off = n = 0
                for a, b in zip(gc, wc):
                    a, b = a.get("self", a), b.get("self", b)
                    for name in ("k", "v"):
                        assert a[name].dtype == torch.int8
                        d = (a[name].cpu().int() - b[name].int()).abs()
                        assert int(d.max()) <= 1
                        off, n = off + int((d > 0).sum()), n + d.numel()
                        torch.testing.assert_close(
                            a[name + "_scale"].cpu(), b[name + "_scale"],
                            rtol=1e-5, atol=0)
                flipped = flipped or off > 0
                torch.testing.assert_close(
                    got.cpu(), want, rtol=1e-4,
                    atol=1e-2 if flipped else 1e-4)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert off <= 0.01 * n


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape", [("command-r-plus-104b", (2, 2)),
                                        ("paligemma-3b", (2, 2)),
                                        ("whisper-large-v3", (2, 1)),
                                        ("whisper-large-v3", (2, 2))])
def test_family_sharded_step_on_the_card(cuda, arch, shape):
    """One float32 (TF32 off) sharded step of a smoke config over shards
    of ``cuda:0`` (command-r's parallel block and paligemma's prefix
    mask over the model axis; whisper over 2 data shards, and its
    encoder and cross-attention over (data 2, model 2)) against the
    single-device step on the card from the same state: as
    ``test_sharded_train_step_on_the_card``."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.configs import smoke
    from repro_torch.launch import specs
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32",
                              remat="full")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ctx = _card_ctx(shape)
    one = init_state(cfg, ocfg, 0, device="cuda")
    two = specs.place_state(one, ctx)
    batch = SyntheticLM(cfg, 4, 64, device="cuda").next()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, m1 = make_train_step(cfg, ocfg)(one, dict(batch))
        with sharding.use(ctx):
            two, m2 = make_train_step(cfg, ocfg)(two, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    got = sharding.gather(two)
    for a, b in zip(leaves(got["opt"]["m"]), leaves(one["opt"]["m"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    for a, b, m in zip(leaves(got["params"]), leaves(one["params"]),
                       leaves(one["opt"]["m"])):
        d = (a - b).abs()
        assert float(d.max()) <= 2e-3
        assert float(torch.where(m.abs() >= 1e-7, d, 0).max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_on_the_card(cuda, arch):
    """One float32 (TF32 off) AdamW step of a smoke config on the card
    against the CPU's from the same state and batch: loss rtol 1e-5,
    every gradient (the first moment) rtol 1e-4 / atol 1e-7 (whisper's
    key biases have a zero gradient but for rounding, ~1e-12 on each
    side), parameters within 2 lr, and within 1e-6 wherever |m| >=
    1e-7."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves

    cfg = dataclasses.replace(smoke(arch), compute_dtype="float32")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_state(cfg, ocfg, 0, device="cpu")
    on_card = init_state(cfg, ocfg, 0, device="cuda")
    for a, b in zip(leaves(on_card["params"]), leaves(state["params"])):
        a.copy_(b)
    batch = SyntheticLM(cfg, 2, 32, device="cpu").next()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, m2 = make_train_step(cfg, ocfg)(
            on_card, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want, m1 = make_train_step(cfg, ocfg)(state, batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for a, b in zip(leaves(got["opt"]["m"]), leaves(want["opt"]["m"])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-7)
    for a, b, m in zip(leaves(got["params"]), leaves(want["params"]),
                       leaves(want["opt"]["m"])):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2e-3
        assert float(torch.where(m.abs() >= 1e-7, d, 0).max()) <= 1e-6


# --------------------------------------------------------------------------
# The two CUDA graphs: Engine's decode step and the all_modes rotation
# --------------------------------------------------------------------------
GRAPH_ARCHS = ("tinyllama-1.1b", "rwkv6-3b", "recurrentgemma-9b",
               "olmoe-1b-7b", "whisper-large-v3")


def _graph_model(arch, cuda):
    """A smoke config on the card (bf16 compute, float32 masters) and its
    extra inputs: 4 prompt tokens of 2 requests, whisper's 48 frames."""
    from repro_torch.configs import smoke
    from repro_torch.models import transformer

    cfg = smoke(arch)
    model = transformer.init_model(cfg, 0, device=cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 4),
                           generator=torch.Generator().manual_seed(7))
    enc = _family_inputs(cfg, 2, 8).get("enc_embeds")
    return cfg, model, prompt.to(cuda), None if enc is None else enc.to(cuda)


def _eager_loop(model, cfg, prompt, n, enc, cuda):
    """Greedy ``decode_step``s on the float32 masters: the tokens and the
    logits after the last."""
    from repro_torch.models import transformer

    cache = transformer.init_cache(cfg, 2, 16, device=cuda,
                                   enc_len=0 if enc is None else 48)
    with torch.no_grad():
        if enc is not None:
            cache = transformer.build_cross_caches(model, cfg, enc, cache)
        for t in range(prompt.shape[1]):
            logits, cache = transformer.decode_step(model, cache, cfg,
                                                    prompt[:, t:t + 1])
        toks = []
        for _ in range(n):
            nxt = logits[:, -1, :cfg.vocab].float().argmax(-1)
            toks.append(nxt)
            logits, cache = transformer.decode_step(model, cache, cfg,
                                                    nxt[:, None])
    return torch.stack(toks, 1), logits


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_engine_bitwise_the_eager_masters(cuda, arch):
    """``Engine.generate`` on the card (one captured step replayed, on
    the bf16 working copies) gives tokens and last logits bitwise those of
    the eager ``decode_step`` loop on the float32 masters; a second
    ``generate`` on the same engine replays with no new capture."""
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving import engine as serving

    cfg, model, prompt, enc = _graph_model(arch, cuda)
    want_toks, want_logits = _eager_loop(model, cfg, prompt, 6, enc, cuda)
    before = serving.CAPTURES["decode_step"]
    eng = Engine(model, cfg, ServeConfig(2, 32), enc_embeds=enc)
    assert eng.graph and eng.step_params is not model
    toks = eng.generate(prompt, 6)
    torch.cuda.synchronize()
    assert serving.CAPTURES["decode_step"] == before + 1
    assert torch.equal(toks, want_toks)
    assert torch.equal(eng.last_logits, want_logits)
    eng.generate(prompt, 3)
    assert serving.CAPTURES["decode_step"] == before + 1
    assert eng.pos == 2 * prompt.shape[1] + 9


@pytest.mark.gpu
def test_graph_engine_capture_failure_raises(cuda, monkeypatch):
    """A step that fails while it is captured (its second call: the first
    runs eagerly) raises out of ``generate``; the engine does not go on
    eagerly."""
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving import engine as serving

    cfg, model, prompt, _ = _graph_model("tinyllama-1.1b", cuda)
    step = serving.decode_step
    calls = []

    def failing(*a):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("capture failed")
        return step(*a)

    monkeypatch.setattr(serving, "decode_step", failing)
    eng = Engine(model, cfg, ServeConfig(2, 32))
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.generate(prompt, 2)
    assert calls == [False, True] and eng._graph is None


def _allocated_after(fn):
    """``memory_allocated`` after ``fn()`` returned and its garbage went
    (the first capture of a process also leaves the capture stream's
    cuBLAS workspace, so callers run ``fn`` once before the baseline)."""
    import gc

    fn()
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


@pytest.mark.gpu
def test_dropping_a_graph_engine_frees_its_pool(cuda):
    from repro_torch.serving import Engine, ServeConfig

    cfg, model, prompt, _ = _graph_model("recurrentgemma-9b", cuda)
    held = []

    def serve():
        eng = Engine(model, cfg, ServeConfig(2, 32))
        eng.generate(prompt, 4)
        assert eng._graph is not None
        held.append(torch.cuda.memory_allocated())

    base = _allocated_after(serve)
    assert _allocated_after(serve) == base < held[-1]


def _rotation_case(cuda, backend, donate=None, nmodes=3):
    idx, val, dims, rng = _coo(nmodes, 2000, 3)
    t = build_flycoo(idx, val, dims, rows_pp=4, block_p=8)
    facs = [torch.from_numpy(rng.standard_normal((d, 32))
                             .astype(np.float32)).to(cuda) for d in dims]
    state = engine.init(t, ExecutionConfig(backend=backend, donate=donate))
    ti, tv = torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda)
    return state, facs, [mttkrp_ref(ti, tv, facs, d, dims[d])
                         for d in range(nmodes)]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
@pytest.mark.parametrize("nmodes", [3, 5])
def test_graph_all_modes_against_eager_mode_steps(cuda, backend, nmodes):
    """The second ``all_modes`` of a state replays its graph: the layout
    after each of its rotations bitwise that of N eager ``mttkrp`` calls,
    the outputs bitwise where two eager rotations repeat bitwise, else
    (both backends' shared-memory atomics add in another order each run,
    an H100 showed) within the oracle's limit; the launches counted at
    the replay."""
    state, facs, oracle = _rotation_case(cuda, backend, nmodes=nmodes)
    eager = []
    s = state
    for _ in range(nmodes):
        out, s = engine.mttkrp(s, facs)
        eager.append(out)
    again, _ = engine.all_modes_eager(state, facs)
    repeats = all(torch.equal(eager[d], again[d]) for d in range(nmodes))
    engine.all_modes(state, facs)                 # eager, then the capture
    assert len(state.graphs) == 1
    name = {"cuda_fused": "mttkrp_fused_remap_compact",
            "cuda": "mttkrp_fused_compact"}[backend]
    before = kmt.LAUNCHES[name]
    outs, nxt = engine.all_modes(state, facs)     # a replay
    torch.cuda.synchronize()
    assert kmt.LAUNCHES[name] == before + nmodes
    for a in ("val", "idx", "alpha"):
        assert torch.equal(getattr(nxt, a), getattr(s, a))
        assert torch.equal(getattr(nxt, a), getattr(state, a))
    for d in range(nmodes):
        if repeats:
            assert torch.equal(outs[d], eager[d])
        torch.testing.assert_close(outs[d], oracle[d], **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("donate", [False, True])
def test_graph_all_modes_donate(cuda, donate):
    """Without ``donate`` the input state stays valid and the returned one
    owns copies; with it the returned state holds the graph's layout
    buffers, and the next rotation from it copies nothing in. The
    default donates on the card."""
    assert ExecutionConfig().resolve_donate()
    state, facs, oracle = _rotation_case(cuda, "cuda_fused", donate)
    keep = [t.clone() for t in (state.val, state.idx, state.alpha)]
    engine.all_modes(state, facs)
    outs, nxt = engine.all_modes(state, facs)
    rot = next(iter(state.graphs.values()))
    assert (nxt.val is rot.layout[0]) == donate
    for t, k in zip((state.val, state.idx, state.alpha), keep):
        assert torch.equal(t, k)
    copies = []
    orig = torch.Tensor.copy_

    def count(dst, src, *a, **k):
        copies.append(dst.data_ptr())
        return orig(dst, src, *a, **k)

    torch.Tensor.copy_ = count
    try:
        outs2, nxt2 = engine.all_modes(nxt, facs)
    finally:
        torch.Tensor.copy_ = orig
    torch.cuda.synchronize()
    layout_in = rot.layout[0].data_ptr() in copies
    assert layout_in != donate
    for d in range(3):
        torch.testing.assert_close(outs2[d], oracle[d], **TOL)
    for a, k in zip(("val", "idx", "alpha"), keep):
        assert torch.equal(getattr(nxt2, a), k)


@pytest.mark.gpu
@pytest.mark.parametrize("donate", [False, True])
def test_dropping_a_state_frees_its_rotation_graph(cuda, donate):
    """A state's graphs live as long as it or a state made from it does
    (they share the tables the graph reads); then the pool goes."""
    held = []

    def rotate():
        state, facs, _ = _rotation_case(cuda, "cuda_fused", donate)
        engine.all_modes(state, facs)
        nxt = engine.all_modes(state, facs)[1]
        assert nxt.graphs is state.graphs and len(state.graphs) == 1
        del state
        held.append(torch.cuda.memory_allocated())
        assert nxt.graphs           # kept by the state made from it

    base = _allocated_after(rotate)
    assert _allocated_after(rotate) == base < held[-1]


@pytest.mark.gpu
def test_cp_als_through_the_rotation_graph(cuda, monkeypatch):
    """``cp_als`` (the ALS fold inside the graph from its second sweep)
    against the same sweeps through the eager loop: fits within 1e-5."""
    idx, val, dims, rng = _coo(3, 3000, 5)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    init = [rng.random((d, 8)).astype(np.float32) for d in dims]
    cfg = ExecutionConfig(backend="cuda_fused")
    graph = cp_als(t, 8, iters=4, factors=init, config=cfg).fits
    monkeypatch.setattr(engine, "all_modes", engine.all_modes_eager)
    eager = cp_als(t, 8, iters=4, factors=init, config=cfg).fits
    assert np.all(np.isfinite(graph))
    assert graph == pytest.approx(eager, abs=1e-5)
