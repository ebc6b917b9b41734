"""The port's spMTTKRP kernels against the reference Pallas kernels.

On the CPU a wrapper runs its plain PyTorch version (a CPU tensor is the
only reason it does); those are held against
``repro.kernels.ops.*(interpret=True)`` on the inputs and shapes of the
reference kernel tests (``tests/test_kernels.py``: its rect shapes,
``_gather_case`` and ``_compact_case``). The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerance for ``out_rel``: rtol = atol = 1e-4, as the reference's own
kernel tests — float32 sums of at most a few hundred products taken in
another order. The remap outputs are copies: bitwise.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import mttkrp as kmt
from test_kernels import _compact_case, _gather_case


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))   # a writable copy


def _port_args(c):
    return dict(
        val=_t(c["val"]), lrow=_t(c["lrow"]), upos=_t(c["upos"], np.int32),
        bpart=_t(c["bpart"], np.int32), uidx=_t(c["uidx"], np.int32),
        nuniq=_t(c["nuniq"], np.int32),
        factors=tuple(_t(f) for f in c["facs"]))


def _remap_inputs(c, seed):
    """idx/alpha with a random permutation as the next-mode destinations
    (as in the reference remap test)."""
    rng = np.random.default_rng(seed)
    s = c["nblocks"] * c["p"]
    n = c["nm1"] + 1
    smax = s + 24
    alive = np.asarray(c["lrow"]) >= 0
    idx = rng.integers(0, 50, (s, n)).astype(np.int32)
    alpha = np.full((s, n), -1, np.int32)
    alpha[alive] = rng.integers(0, smax, (int(alive.sum()), n))
    alpha[alive, 1] = rng.permutation(smax)[: int(alive.sum())]
    return idx, alpha, smax


CASES = [((2, (3, 1), 8), (2, 8)), ((4, (1, 4, 2, 1), 16), (3, 32)),
         ((3, (2, 1, 5), 32), (5, 16)), ((3, (1, 1, 2), 16), (4, 8))]


@pytest.mark.parametrize("shape,fac", CASES)
def test_plain_gather_compact_matches_pallas(shape, fac):
    (kappa, part_blocks, p), (nm1, r) = shape, fac
    c = _compact_case(kappa * 7 + nm1, kappa, part_blocks, p, nm1, r)
    kw = dict(kappa=c["kappa"], rows_pp=c["rows_pp"], nblocks=c["nblocks"],
              block_p=c["p"])
    want = ops.mttkrp_fused_gather_compact(
        c["val"], c["lrow"], c["upos"], c["bpart"], c["uidx"], c["nuniq"],
        c["facs"], interpret=True, **kw)
    a = _port_args(c)
    got = kmt.mttkrp_fused_gather_compact(
        a["val"], a["lrow"], a["upos"], a["bpart"], a["uidx"], a["nuniq"],
        a["factors"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert kmt.LAUNCHES["mttkrp_fused_gather_compact"] == 0  # no launch


@pytest.mark.parametrize("shape,fac", CASES[:3])
def test_plain_remap_compact_matches_pallas(shape, fac):
    (kappa, part_blocks, p), (nm1, r) = shape, fac
    c = _compact_case(13 * kappa + p, kappa, part_blocks, p, nm1, r)
    idx, alpha, smax = _remap_inputs(c, p + nm1)
    kw = dict(kappa=c["kappa"], rows_pp=c["rows_pp"], nblocks=c["nblocks"],
              block_p=c["p"], smax=smax, next_mode=1)
    want = ops.mttkrp_fused_remap_compact(
        c["val"], idx, alpha, c["lrow"], c["upos"], c["bpart"], c["uidx"],
        c["nuniq"], c["facs"], interpret=True, **kw)
    a = _port_args(c)
    got = kmt.mttkrp_fused_remap_compact(
        a["val"], _t(idx), _t(alpha), a["lrow"], a["upos"], a["bpart"],
        a["uidx"], a["nuniq"], a["factors"], **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


RECT = [(2, 8, 1, 8), (4, 16, 3, 16), (8, 4, 2, 32), (3, 128, 2, 128)]


@pytest.mark.parametrize("kappa,rows_pp,blocks_pp,p", RECT)
@pytest.mark.parametrize("nm1,r", [(2, 8), (3, 32)])
def test_plain_fused_matches_pallas(kappa, rows_pp, blocks_pp, p, nm1, r):
    """Rect EC over a pre-gathered operand (the reference test's inputs:
    random rows, pads zeroed)."""
    rng = np.random.default_rng(kappa * 1000 + nm1)
    s = kappa * blocks_pp * p
    g = rng.standard_normal((s, nm1, r)).astype(np.float32)
    val = rng.standard_normal(s).astype(np.float32)
    lrow = rng.integers(-1, rows_pp, s).astype(np.int32)
    val[lrow < 0] = 0.0
    kw = dict(kappa=kappa, rows_pp=rows_pp, blocks_pp=blocks_pp, block_p=p)
    want = ops.mttkrp_fused(g, val, lrow, interpret=True, **kw)
    got = kmt.mttkrp_fused(_t(g), _t(val), _t(lrow), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,fac", CASES)
def test_plain_fused_compact_matches_pallas(shape, fac):
    (kappa, part_blocks, p), (nm1, r) = shape, fac
    c = _compact_case(kappa * 10 + p, kappa, part_blocks, p, nm1, r)
    kw = dict(kappa=c["kappa"], rows_pp=c["rows_pp"], nblocks=c["nblocks"],
              block_p=c["p"])
    want = ops.mttkrp_fused_compact(c["gathered"], c["val"], c["lrow"],
                                    c["bpart"], interpret=True, **kw)
    a = _port_args(c)
    got = kmt.mttkrp_fused_compact(_t(c["gathered"]), a["val"], a["lrow"],
                                   a["bpart"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _rect_gather_args(c):
    facs, lidx, val, lrow, _ = c
    return (_t(val), _t(lrow), _t(lidx, np.int32),
            tuple(_t(f) for f in facs))


@pytest.mark.parametrize("kappa,rows_pp,blocks_pp,p", RECT[:3])
@pytest.mark.parametrize("nm1,r", [(2, 8), (3, 32), (5, 16)])
def test_plain_gather_matches_pallas(kappa, rows_pp, blocks_pp, p, nm1, r):
    c = _gather_case(kappa * 100 + nm1, kappa, rows_pp, blocks_pp, p, nm1, r)
    facs, lidx, val, lrow, _ = c
    kw = dict(kappa=kappa, rows_pp=rows_pp, blocks_pp=blocks_pp, block_p=p)
    want = ops.mttkrp_fused_gather(val, lrow, lidx, facs, interpret=True,
                                   **kw)
    got = kmt.mttkrp_fused_gather(*_rect_gather_args(c), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kappa,rows_pp,blocks_pp,p,nm1,r", [
    (2, 8, 1, 8, 2, 8), (3, 4, 2, 16, 3, 32)])
def test_plain_remap_matches_pallas(kappa, rows_pp, blocks_pp, p, nm1, r):
    c = _gather_case(7 * kappa + p, kappa, rows_pp, blocks_pp, p, nm1, r)
    facs, lidx, val, lrow, _ = c
    idx, alpha, smax = _remap_inputs(
        {"nblocks": kappa * blocks_pp, "p": p, "nm1": nm1, "lrow": lrow},
        p + nm1)
    kw = dict(kappa=kappa, rows_pp=rows_pp, blocks_pp=blocks_pp, block_p=p,
              smax=smax, next_mode=1)
    want = ops.mttkrp_fused_remap(val, idx, alpha, lrow, lidx, facs,
                                  interpret=True, **kw)
    v, lr, li, fs = _rect_gather_args(c)
    got = kmt.mttkrp_fused_remap(v, _t(idx), _t(alpha), lr, li, fs, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_block_starts_from_descriptor():
    bpart = torch.tensor([0, 0, 0, 1, 2, 2, 3], dtype=torch.int32)
    assert kmt.block_starts(bpart, 4).tolist() == [0, 3, 4, 6, 7]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU a wrapper launches or raises: a non-CUDA device raises,
    and a tile that does not fit in shared memory raises before any
    launch (never a fallback to the plain version)."""
    s, nm1, r = 16, 2, 32
    meta = dict(device="meta")
    val = torch.empty(s, **meta)
    lrow = torch.empty(s, dtype=torch.int32, **meta)
    upos = torch.empty((s, nm1), dtype=torch.int32, **meta)
    bpart = torch.empty(2, dtype=torch.int32, **meta)
    uidx = torch.empty((nm1, s), dtype=torch.int32, **meta)
    nuniq = torch.empty((nm1, 2), dtype=torch.int32, **meta)
    facs = tuple(torch.empty((5, r), **meta) for _ in range(nm1))
    args = (val, lrow, upos, bpart, uidx, nuniq, facs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kmt.mttkrp_fused_gather_compact(*args, kappa=2, rows_pp=4,
                                        nblocks=2, block_p=8)
    with pytest.raises(ValueError, match="does not fit"):
        kmt.mttkrp_fused_gather_compact(*args, kappa=2, rows_pp=4000,
                                        nblocks=2, block_p=8)


def _meta_calls(rows_pp):
    """Each rect / pre-gathered wrapper on meta tensors of a 2-partition,
    2-block plan (P = 8, R = 32, three modes)."""
    s, nm1, r = 16, 2, 32
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    val, lrow = torch.empty(s, **meta), torch.empty(s, **i32)
    idx = alpha = torch.empty((s, nm1 + 1), **i32)
    lidx = torch.empty((nm1, s), **i32)
    gathered = torch.empty((s, nm1, r), **meta)
    bpart = torch.empty(2, **i32)
    facs = tuple(torch.empty((5, r), **meta) for _ in range(nm1))
    rect = dict(kappa=2, rows_pp=rows_pp, blocks_pp=1, block_p=8)
    return {
        "mttkrp_fused": lambda: kmt.mttkrp_fused(gathered, val, lrow,
                                                 **rect),
        "mttkrp_fused_compact": lambda: kmt.mttkrp_fused_compact(
            gathered, val, lrow, bpart, kappa=2, rows_pp=rows_pp,
            nblocks=2, block_p=8),
        "mttkrp_fused_gather": lambda: kmt.mttkrp_fused_gather(
            val, lrow, lidx, facs, **rect),
        "mttkrp_fused_remap": lambda: kmt.mttkrp_fused_remap(
            val, idx, alpha, lrow, lidx, facs, smax=20, next_mode=1,
            **rect),
    }


@pytest.mark.parametrize("name", ["mttkrp_fused", "mttkrp_fused_compact",
                                  "mttkrp_fused_gather",
                                  "mttkrp_fused_remap"])
def test_rect_and_pregathered_wrappers_refuse(name):
    """The same refusals for the four other wrappers, each at its own
    kernel's shared-memory formula (P = 8, R = 32, two inputs): the
    largest tile that fits passes the check and one row more does not.
    The pre-gathered kernel stages the block's operand, the gather
    kernels its factor rows (and idx/alpha for the remap), beside two
    blocks of metadata."""
    smem = {"mttkrp_fused": kmt.pregathered_smem_bytes(0, 32, 2, 8),
            "mttkrp_fused_compact": kmt.pregathered_smem_bytes(0, 32, 2, 8),
            "mttkrp_fused_gather": kmt.gather_smem_bytes(0, 32, 2, 8, 0),
            "mttkrp_fused_remap": kmt.gather_smem_bytes(0, 32, 2, 8, 3)}
    rows = (kmt.SMEM_PER_BLOCK - smem[name]) // (4 * 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _meta_calls(rows_pp=4)[name]()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _meta_calls(rows_pp=rows)[name]()
    with pytest.raises(ValueError, match="does not fit"):
        _meta_calls(rows_pp=rows + 1)[name]()
    assert kmt.LAUNCHES[name] == 0
