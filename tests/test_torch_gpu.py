"""Card-only tests of the port: the CUDA kernels against their plain
versions, the ``cuda_fused`` rotation against the COO oracle, and CPD on
the card. Every test is marked ``gpu`` and skips itself where torch sees
no card. The file imports neither ``jax`` nor ``repro``, so it runs on a
machine with PyTorch and the CUDA toolkit only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: ``out_rel`` and MTTKRP outputs rtol = atol = 2e-4 (float32
sums of at most a few hundred products, shared-memory atomics against
``index_add_``); remap outputs and layouts bitwise; CPD fits 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.core import build_flycoo, cp_als, mttkrp_ref
from repro_torch.core.flycoo import _ROW_SENTINEL, _dedup_tables_batched
from repro_torch.engine import ExecutionConfig
from repro_torch.kernels import mttkrp as kmt

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
    ((2, 3), 128, 4, 64, 1)])
def test_cuda_kernels_match_plain(cuda, part_blocks, p, nm1, r, empty):
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
    for k in before:
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
def test_cp_als_cuda_fused_matches_torch_backend(cuda):
    idx, val, dims, rng = _coo(5, 3000, 1)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    init = [rng.random((d, 8)).astype(np.float32) for d in dims]
    fits = [cp_als(t, 8, iters=3, factors=init,
                   config=ExecutionConfig(backend=b)).fits
            for b in ("cuda_fused", "torch")]
    assert all(np.isfinite(fits[0]))
    assert fits[0] == pytest.approx(fits[1], abs=1e-4)
